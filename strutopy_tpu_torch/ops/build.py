"""Build and load the CUDA kernels (``csrc/stages.cu``, ``csrc/newton.cu``,
``csrc/scatter.cu``, ``csrc/factor.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``.  The build
runs at first use, into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), and is cached by a hash of every file under
``csrc/`` (headers included) and the flags.  Processes that start
together on a cold cache (the ranks of a mesh) build once: the build runs
under a file lock, ``build/kernels/.build.lock``, and a process that
waited on it loads what the first one built.  Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "stages.cu", CSRC / "newton.cu", CSRC / "scatter.cu", CSRC / "factor.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "stm_fgh_smem": [_I] * 3,
    "stm_fgh": [_P] * 8 + [_I] * 5 + [_P],
    "stm_cg": [_P] * 3 + [_I] * 4 + [_P],
    "stm_cg_plan": [_I] * 2 + [_P],
    "stm_ls_smem": [_I] * 2,
    "stm_stage_plan": [_I] * 4 + [_P],
    "stm_ls": [_P] * 8 + [_I] * 5 + [_P],
    "stm_newton_plan": [_I] * 5 + [_P],
    "stm_iter": [_P] * 11 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "stm_newton": [_P] * 9 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    "stm_gather_rows": [_P] * 3 + [_I] * 3 + [_P],
    "stm_scatter_phi": [_P] * 4 + [_I] * 3 + [_P],
    "stm_newton_direction": [_P] * 5 + [_I] * 2 + [_F, _P],
    "stm_newton_accept": [_P] * 14 + [_I] * 3 + [_P],
    "stm_finalize_plan": [_I, _P],
    "stm_finalize": [_P] * 12 + [_I] * 3 + [_P],
    "stm_finalize_bound": [_P] * 6 + [_I] * 2 + [_P],
    "stm_factor_plan": [_I, _P],
    "stm_chol_pd_inverse": [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
        "kernels are compiled from strutopy_tpu_torch/csrc at first use"
    )


def _digest() -> str:
    """Hash of the flags and of every file under ``csrc/`` with its name,
    so an edit to a header the sources include rebuilds the library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(src.relative_to(CSRC).as_posix().encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstm_stages_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for this source exists.

    One ``nvcc -c`` per source, all started together, then one link.
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel), headed by each source's compile seconds, is kept beside
    the library; :func:`ptxas_report` reads it.  Concurrent builders (the
    ranks of a mesh, on one machine) serialize on a file lock.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # else another process built it while this one waited
            _compile(out, nvcc)
    return out


def _compile(out: Path, nvcc: str) -> None:
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])

    def run(cmd):
        t0 = time.time()
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return cmd, done.stdout, done.returncode, time.time() - t0

    report = []
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            timed = list(pool.map(run, cmds[:-1]))
        report.append("".join(f"nvcc {src.name}: {sec:.1f} s\n"
                              for src, (*_, sec) in zip(SOURCES, timed)))
        results = [r[:3] for r in timed]
        if all(rc == 0 for *_, rc in results):
            link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            results.append((cmds[-1], link.stdout, link.returncode))
        for cmd, text, rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
            report.append(text)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, out)


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
