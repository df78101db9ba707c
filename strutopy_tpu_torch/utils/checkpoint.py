"""Resumable EM state checkpointing (twin of
``strutopy_tpu/utils/checkpoint.py``).

The full EM state (every :class:`STMState` field in its own dtype, the
bound history and the iteration counter) round-trips through a single
``.npz`` with the JAX package's layout, so either package resumes the
other's checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from strutopy_tpu_torch.models.state import STMState

_FIELDS = tuple(f.name for f in dataclasses.fields(STMState))


def save_checkpoint(path: str, state: STMState, bounds, em_iter: int,
                    config_json: Optional[str] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f: getattr(state, f).detach().cpu().numpy() for f in _FIELDS}
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            __bounds=np.asarray(bounds, np.float64),
            __em_iter=np.asarray(em_iter),
            __config=np.frombuffer((config_json or "").encode(), dtype=np.uint8),
            **arrays,
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, *, device="cuda") -> Tuple[STMState, list, int, Optional[str]]:
    """(state on ``device``, bounds, em_iter, config json or None)."""
    dev = torch.device(device)
    with np.load(path, allow_pickle=False) as z:
        fields = {f: torch.as_tensor(z[f], device=dev) for f in _FIELDS if f in z}
        # checkpoints written before a field existed
        if "opt_iters" not in fields and "eta" in fields:
            fields["opt_iters"] = torch.zeros(
                fields["eta"].shape[0], dtype=torch.int32, device=dev)
        if "straggler_overflow" not in fields:
            fields["straggler_overflow"] = torch.zeros((), dtype=torch.int32, device=dev)
        missing = [f for f in _FIELDS if f not in fields]
        if missing:
            raise ValueError(
                f"checkpoint {path} lacks state fields {missing} and no "
                "compatibility default is defined for them"
            )
        state = STMState(**fields)
        bounds = list(z["__bounds"])
        em_iter = int(z["__em_iter"])
        cfg = bytes(z["__config"]).decode() or None
    return state, bounds, em_iter, cfg
