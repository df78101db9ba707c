"""Carry an STM state between the JAX package and the port.

Both directions go through a dict of numpy arrays keyed by the state's
field names, which is what ``{f: np.asarray(getattr(s, f)) for f in
s._fields}`` gives for a JAX ``STMState`` ``s``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from strutopy_tpu_torch.models.state import STMState

_INT_FIELDS = ("opt_iters", "straggler_overflow")


def state_from_numpy(d: dict, device) -> STMState:
    """A port :class:`STMState` on ``device`` from numpy arrays."""
    out = {}
    for f in dataclasses.fields(STMState):
        dt = torch.int32 if f.name in _INT_FIELDS else torch.float32
        # a copy: arrays from jax are read-only views of device buffers
        out[f.name] = torch.tensor(np.asarray(d[f.name]), dtype=dt, device=device)
    return STMState(**out)


def state_to_numpy(state: STMState) -> dict:
    """The state's fields as numpy arrays on the host."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(STMState)}
