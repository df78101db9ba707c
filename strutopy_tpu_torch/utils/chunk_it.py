"""List chunking (a copy of ``strutopy_tpu/utils/chunk_it.py``), kept for
API compatibility and host-side work splitting.
"""

from __future__ import annotations


def chunk_it(seq, num: int):
    """Split ``seq`` into ``num`` (nearly) equal contiguous chunks."""
    if num <= 0:
        raise ValueError("num must be positive")
    avg = len(seq) / float(num)
    out = []
    last = 0.0
    while last < len(seq):
        out.append(seq[int(last) : int(last + avg)])
        last += avg
    return out


chunkIt = chunk_it  # reference spelling
