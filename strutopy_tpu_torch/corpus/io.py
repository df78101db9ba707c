"""Model artifact I/O (numpy copy of part of ``strutopy_tpu/corpus/io.py``).

Reads the ``*_hat.npy`` artifact directory that either package's
``STM.save_model`` writes (and the reference's committed artifacts).
Every file is treated as pure data: ``allow_pickle=False`` for the
arrays and a restricted unpickler for the bound trace, so opening a
foreign artifact directory can never execute code embedded in it.
"""

from __future__ import annotations

import importlib
import os
import pickle

import numpy as np


class _BoundUnpickler(pickle.Unpickler):
    """Restricted unpickler for ``lower_bound.pickle`` (a list of plain
    floats from this package; the reference may store numpy scalars).
    Only numpy's scalar-reconstruction globals are admitted."""

    _ALLOWED = {
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "dtype"),
        ("numpy", "float64"),
        ("numpy", "float32"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from lower_bound.pickle: "
            "model artifacts must not contain arbitrary objects"
        )


def load_model_artifacts(model_dir: str) -> dict:
    """Load a ``*_hat.npy`` artifact directory.

    Returns a dict with whatever of beta/theta/sigma/eta/mu/gamma/X/
    kappa/lower_bound exists.
    """
    out = {}
    for name in ("beta", "theta", "sigma", "eta", "mu", "gamma", "kappa"):
        p = os.path.join(model_dir, f"{name}_hat.npy")
        if os.path.exists(p):
            out[name] = _load_plain_array(p)
    xp = os.path.join(model_dir, "X.npy")
    if os.path.exists(xp):
        out["X"] = _load_plain_array(xp)
    lb = os.path.join(model_dir, "lower_bound.pickle")
    if os.path.exists(lb):
        with open(lb, "rb") as f:
            out["lower_bound"] = _BoundUnpickler(f).load()
    return out


def _load_plain_array(path: str) -> np.ndarray:
    try:
        return np.load(path, allow_pickle=False)
    except ValueError as e:
        raise ValueError(
            f"{path} contains pickled Python objects; model artifacts are "
            "plain numeric arrays (save_model writes them that way) — "
            "refusing to unpickle"
        ) from e
