"""The benchmark of ``strutopy_tpu_torch`` (the PyTorch/CUDA port).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Everything a cell is made of
is found by name: its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` (which names the driver in
``drivers/``), its limits in ``limits/<cell>.json`` and each per-layer
metric's reader in ``metrics/<metric>.py``.  The plain reference that
decides ``correct`` is in ``reference/`` and imports nothing of the
program.
"""
