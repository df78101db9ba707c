"""torch.distributed worlds for the port's mesh tests, on the CPU over gloo.

Every world meets through a file store in a test's temporary directory,
never a TCP port, so parallel test workers cannot collide.
"""

import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import time

import torch
import torch.distributed as dist

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")


@contextlib.contextmanager
def one_thread():
    """torch's CPU ops on one thread, the count restored on exit.  A fit
    at toy size spends its time handing tiny ops to the thread pool, and
    on a machine whose cores are all busy (parallel test workers) each
    hand-off waits on the others: such a fit ran 40 times slower there
    on eight threads than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def world_of_one(tmp_path):
    """A gloo world of this process alone, destroyed on exit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def start_world(out_dir, world: int):
    """Start ``world`` ranks of ``torch_parallel_worker.py`` on
    ``out_dir`` (which holds ``inputs.pkl``) -> their processes."""
    procs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"log{r}.txt"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                                           str(out_dir)], stdout=log, stderr=subprocess.STDOUT))
    return procs


def join_world(procs, out_dir, timeout: float):
    """Wait for every rank; the first rank to fail, or the deadline, ends
    the world (every rank still running is killed) and raises with that
    rank's log.  -> each rank's pickled results, in rank order."""
    deadline = time.monotonic() + timeout
    failed = None
    while time.monotonic() < deadline:
        rcs = [p.poll() for p in procs]
        failed = next((r for r, rc in enumerate(rcs) if rc not in (None, 0)), None)
        if failed is not None or all(rc == 0 for rc in rcs):
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed is None and any(p.returncode != 0 for p in procs):
        raise AssertionError(f"the world outlived its {timeout} s limit and was ended")
    if failed is not None:
        with open(os.path.join(out_dir, f"log{failed}.txt")) as f:
            raise AssertionError(f"rank {failed} failed:\n{f.read()[-6000:]}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
