"""Device meshes over ``torch.distributed`` (twin of
``strutopy_tpu/parallel/mesh.py``).

One process a card.  A single fit scales across processes: documents
shard over the ``docs`` axis of the mesh and the E-step's sufficient
statistics are summed with ``all_reduce`` over that axis; on a 2-D mesh
beta's vocabulary shards over the ``vocab`` axis as well.

The SPMD contract: the caller starts the world (for example
``torchrun --nproc-per-node N``), and every rank calls every public
entry point with the same arguments and the same full corpus, as the
JAX package's single controller holds it.  Each rank keeps its own
document shard; collectives run only at points every rank reaches.

The backend is the caller's: NCCL for CUDA tensors, gloo for the CPU
(gloo also carries CUDA tensors).  The port only ever calls
``all_reduce`` (SUM and MAX), so the one code path serves both.

Divergences from the JAX package: a mesh covers the whole world (JAX
takes the first ``n`` of a longer device list; here a rank outside the
mesh would have no part in a fit, so that raises), and
:func:`default_mesh` is None without a process group.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

DOC_AXIS = "docs"
VOCAB_AXIS = "vocab"

# torchrun's environment, all of which init_from_env needs
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: the process group along
    the axis through this rank, this rank's coordinate on it, its size."""

    group: object
    rank: int
    size: int


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_from_env(backend: str, device: str = "cuda",
                  timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Start the default process group from torchrun's environment and
    return this rank's device: ``cuda:LOCAL_RANK`` (made current) for
    ``device="cuda"``, else the CPU.  ``backend`` is the caller's choice
    (``"nccl"`` or ``"gloo"``); nothing is picked here.  Raises
    ``RuntimeError`` naming torchrun when its environment is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no torchrun environment ({', '.join(missing)} unset): start "
            "one process a device with torchrun --nproc-per-node N")
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend=backend, init_method="env://", **kw)
    return dev


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, else ``cpu`` (gloo
    carries CUDA tensors too; the type only names the mesh)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _require_world(call: str, need: int) -> None:
    have = world_size()
    if not (dist.is_available() and dist.is_initialized()) or have < need:
        raise ValueError(
            f"{call} needs {need} devices but the world has {have} rank(s); "
            f"start {need} processes (torchrun --nproc-per-node {need}) and "
            "their process group first")
    if have > need:
        raise ValueError(
            f"{call} covers {need} of the world's {have} ranks: a mesh must "
            "cover the whole world (a rank outside it has no part in a fit)")


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None):
    """1-D document mesh over every rank of the world.

    ``n_devices`` (or ``len(devices)``, the ranks) must equal the world
    size: more raises ``ValueError`` ("needs N devices"), as JAX does,
    and fewer raises too (see the module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_devices if n_devices is not None else (
        len(devices) if devices is not None else world_size())
    if devices is not None and list(devices) != list(range(len(devices))):
        raise ValueError(f"make_mesh: devices must be the world's ranks in order, "
                         f"got {list(devices)}")
    _require_world(f"make_mesh({n})", n)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(DOC_AXIS,))


def make_mesh_2d(n_doc_shards: int, n_vocab_shards: int, devices: Optional[Sequence] = None):
    """2-D (docs, vocab) mesh for vocabulary-sharded EM, row-major over
    the ranks (rank = doc · n_vocab + vocab), the document axis
    outermost as in JAX.  beta, beta_ss and kappa shard their vocabulary
    over the second axis; the per-chunk beta_doc all-reduce runs within
    a row, between neighbouring ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    need = n_doc_shards * n_vocab_shards
    if devices is not None and list(devices) != list(range(need)):
        raise ValueError(f"make_mesh_2d: devices must be the world's {need} ranks in "
                         f"order, got {list(devices)}")
    _require_world(f"make_mesh_2d({n_doc_shards}, {n_vocab_shards})", need)
    return init_device_mesh(_device_type(), (n_doc_shards, n_vocab_shards),
                            mesh_dim_names=(DOC_AXIS, VOCAB_AXIS))


def default_mesh():
    """Document mesh over the whole world; None without a process group
    or with a world of one."""
    if world_size() <= 1:
        return None
    return make_mesh()


def mesh_axis(mesh, name: str) -> Optional[MeshAxis]:
    """This rank's view of axis ``name`` of ``mesh``; None when the mesh
    has no such axis (the vocab axis of a 1-D mesh)."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return None
    return MeshAxis(mesh.get_group(name), mesh.get_local_rank(name),
                    mesh.size(names.index(name)))


def doc_axis(mesh) -> MeshAxis:
    return mesh_axis(mesh, DOC_AXIS)


def vocab_axis(mesh) -> Optional[MeshAxis]:
    return mesh_axis(mesh, VOCAB_AXIS)


def all_sum(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """``x`` summed over ``axis`` (in place; the identity without one)."""
    if axis is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


def all_max(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """``x`` maximized over ``axis`` (in place; the identity without one)."""
    if axis is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis.group)
    return x


def barrier(mesh, device) -> None:
    """Wait until every rank of ``mesh`` has reached this point: one
    all-reduce along each axis, then a host read, so the host waits for
    NCCL too (the port's only collective is ``all_reduce``)."""
    t = torch.zeros(1, device=device)
    for name in mesh.mesh_dim_names:
        all_sum(t, mesh_axis(mesh, name))
    t.item()


def is_first(mesh) -> bool:
    """True on the mesh's first rank (the one that writes files)."""
    return mesh is None or all(mesh.get_local_rank(n) == 0 for n in mesh.mesh_dim_names)
