"""True-float32 products, scoped to the package's entry points.

Every model quantity is float32.  On the GPU a float32 matmul or
convolution may run in TF32 (about three decimal digits) when the host
program has turned that on, so each entry point of the package runs
inside :func:`float32_matmul`, which turns TF32 off and puts the flags
back as it found them — the counterpart of the JAX package's
``Precision.HIGH`` on its finalize and linear algebra.  Importing the
package changes nothing.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

# The flags are process-wide, so entries are counted under a lock: the
# first one in saves them, the last one out restores them.
_lock = threading.Lock()
_depth = 0
_saved = (False, False)


@contextlib.contextmanager
def float32_matmul():
    """Set ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False; restore both on exit.

    Re-entrant and safe across threads: the outermost entry of the
    process saves the flags and the last exit restores them, so two
    threads inside entry points at once cannot leave a flag changed."""
    global _depth, _saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _lock:
        if _depth == 0:
            _saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = False
            cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _saved


def true_float32(fn):
    """Decorator: run ``fn`` inside :func:`float32_matmul`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with float32_matmul():
            return fn(*args, **kwargs)

    return wrapper
