"""Build and load the CUDA stage kernels (``csrc/stages.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The build
runs at first use, into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), and is cached by a hash of the source and
the flags.  Nothing here runs at import: the CPU tests import every
module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "stages.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "stm_fgh": [_P] * 8 + [_I] * 4 + [_P],
    "stm_cg": [_P] * 3 + [_I] * 4 + [_P],
    "stm_ls": [_P] * 8 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA stage "
        "kernels are compiled from strutopy_tpu_torch/csrc at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstm_stages_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for this source exists.

    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel) is kept beside the library; :func:`ptxas_report` reads it.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the build (after :func:`load`)."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.stm_error_string.argtypes = [ctypes.c_int]
            lib.stm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = load().stm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
