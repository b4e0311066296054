"""
Process groups for multi-GPU inference (counterpart of
`bild_tpu.parallel.mesh`).

`bild_tpu` runs one SPMD program on a JAX mesh of devices that may span
processes: XLA places the rows of a global array on the devices and
gathers them back. PyTorch has no SPMD program, so here a mesh is a
`torch.distributed` process group with one rank per GPU. One process
drives one GPU: `bild_tpu`'s one-process mesh over several chips has no
counterpart. Each rank computes only the rows it owns (`shard_batch`,
`feed_process_local`), and the small per-row results are all-gathered
(`fetch_to_host`), so that every rank holds the full result, as in
`bild_tpu`. One axis is sharded: ``data`` (the rows of a batch, for the
dataset runners) or, on a mesh without ``data``, ``time`` (the frames of
a trajectory, for `MultiStateRouse.logL_batch_assoc`). Nothing in
`bild_tpu` shards over its axis ``prof``, and here it must have size 1.

Collectives move raw bytes of fixed-shape arrays, never pickled objects:
float64 bits, ``-inf`` and ``NaN`` arrive unchanged.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_DEVICE, resolve_device

__all__ = ["Mesh", "make_mesh", "shard_batch", "initialize_distributed",
           "is_multiprocess", "fetch_to_host", "broadcast_from_process0",
           "feed_process_local", "require_data_axis", "all_gather_tensor",
           "all_reduce_sum"]

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    """A process group over which a batch's rows (or a trajectory's
    frames) are split: rank ``ranks[i]`` owns the i-th contiguous block.
    ``shape`` is ``{"data": D}``, ``{"data": D, "prof": 1}`` or ``{"time":
    W}``; ``rank`` is this
    process's global rank and ``device`` the device it computes on;
    ``group`` is the process group (None: the default group, or none at
    all for one rank) and ``backend`` its backend."""

    shape: dict
    ranks: tuple
    rank: int
    device: torch.device
    group: object = None
    backend: Optional[str] = None

    @property
    def index(self) -> int:
        """This rank's position in the mesh: the block of rows it owns."""
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not in the mesh (ranks "
                             f"{list(self.ranks)})")
        return self.ranks.index(self.rank)


def _world_size_hint(num_processes=None) -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes is not None:
        return int(num_processes)
    return int(os.environ.get("WORLD_SIZE", 1))


def _pick_backend(device_type: str, world_size: int) -> str:
    """``nccl`` when every rank has a GPU of its own, else ``gloo`` (CPU
    ranks, or several ranks of a host sharing a GPU)."""
    if device_type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None,
                           timeout=DEFAULT_TIMEOUT):
    """
    Join the process group of a multi-process run; idempotent.

    With ``coordinator_address='host:port', num_processes, process_id``
    the group meets at ``tcp://host:port``; without them it is read from
    the environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them). ``backend=None``
    picks ``nccl`` when every rank of a host has a GPU of its own, else
    ``gloo``. ``timeout`` bounds every collective.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = _pick_backend("cuda" if torch.cuda.is_available() else "cpu",
                                _world_size_hint(num_processes))
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)


def make_mesh(shape=None, axis_names=("data", "prof"), devices=None,
              distributed=False, backend=None, **distributed_kw) -> Mesh:
    """
    A mesh of ranks. Without ``distributed`` it is this process alone
    (one rank, no process group). With ``distributed=True`` it first joins
    the process group (`initialize_distributed`, which takes
    ``distributed_kw``) and spans the world's ranks, or the first
    ``shape[0]`` of them.

    ``devices`` is where this rank computes: ``None`` or ``"cuda"`` for
    the GPU of its local rank (``LOCAL_RANK``, else its rank, modulo the
    GPUs of the host; raises without a GPU), ``"cpu"`` for the CPU (as
    the tests run), or an explicit device. ``backend=None`` picks ``nccl``
    when every rank has a GPU of its own and ``gloo`` otherwise. The
    sharded axis is ``data``, or ``time`` on a mesh without ``data``
    (``make_mesh((W,), axis_names=("time",))``, for
    `MultiStateRouse.logL_batch_assoc`); every other axis must have size 1
    (``ValueError`` otherwise).
    """
    device = resolve_device(DEFAULT_DEVICE if devices is None else devices)
    if distributed:
        if backend is None:
            backend = _pick_backend(
                device.type,
                _world_size_hint(distributed_kw.get("num_processes")))
        initialize_distributed(backend=backend, **distributed_kw)
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda" and distributed:
        torch.cuda.set_device(device)

    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    sizes = dict(zip(axis_names, shape))
    axis = next((a for a in ("data", "time") if a in sizes), None)
    if axis is None:
        raise ValueError(f"a mesh needs a 'data' axis (or a 'time' axis), "
                         f"got {axis_names}")
    wide = {a: s for a, s in sizes.items() if a != axis and s != 1}
    if wide:
        raise ValueError(f"only the '{axis}' axis is sharded; axes {wide} "
                         "must have size 1")
    if sizes[axis] > world:
        raise ValueError(f"mesh shape {shape} needs {sizes[axis]} devices; "
                         f"only {world} available (one rank per GPU)")
    ranks = tuple(range(sizes[axis]))
    group = None
    if distributed and len(ranks) < world:
        group = dist.new_group(list(ranks))      # every rank must call it
    return Mesh(sizes, ranks, rank, device, group, backend)


def is_multiprocess(mesh: Mesh) -> bool:
    """True iff the mesh spans more than one rank."""
    return len(mesh.ranks) > 1


def require_data_axis(mesh: Mesh | None) -> None:
    """Raise ``ValueError`` unless ``mesh`` is None or has a ``data`` axis:
    the dataset runners split rows, not frames."""
    if mesh is not None and "data" not in mesh.shape:
        raise ValueError(f"the dataset runners need a mesh with a 'data' "
                         f"axis, got axes {tuple(mesh.shape)} (a 'time' mesh "
                         "serves MultiStateRouse.logL_batch_assoc)")


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [y for x in tree for y in _leaves(x)]
    if isinstance(tree, dict):
        return [y for v in tree.values() for y in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def shard_batch(batch, mesh: Mesh, axis="data"):
    """
    This rank's block of rows of a host-global tree (tuples, lists, dicts
    of arrays or tensors with a leading batch axis): rows ``[i B/D, (i+1)
    B/D)`` for the rank at position ``i`` of ``D``, the block that
    ``NamedSharding(P('data'))`` gives device ``i`` in `bild_tpu`. Scalars
    pass through. A leading dimension not divisible by ``D`` raises (pad
    first: `pad_batch_rows`).
    """
    n_shards = mesh.shape[axis]
    i = mesh.index

    def block(x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        if x.shape[0] % n_shards != 0:
            raise ValueError(
                f"leading dimension {x.shape[0]} is not divisible by mesh "
                f"axis '{axis}' ({n_shards}); pad the batch first "
                f"(bild_tpu_torch.parallel.pad_batch_rows)")
        n = x.shape[0] // n_shards
        return x[i * n:(i + 1) * n]

    return _tree_map(block, batch)


def feed_process_local(local_rows, mesh: Mesh, axis="data",
                       global_batch: int | None = None) -> torch.Tensor:
    """
    This rank's own rows of a global batch, on the rank's device: in the
    port a global array fed process-locally is just its local block. With
    ``global_batch``, checks that the rows are this rank's share of it
    (``global_batch / D``).
    """
    x = torch.as_tensor(local_rows)
    if global_batch is not None:
        D = mesh.shape[axis]
        if global_batch % D != 0 or x.shape[0] != global_batch // D:
            raise ValueError(
                f"{x.shape[0]} local rows are not this rank's share of a "
                f"global batch of {global_batch} over {D} ranks")
    return x.to(mesh.device)


def _comm_device(backend, device):
    """Where a collective's buffers must lie: the rank's GPU under NCCL,
    the host otherwise."""
    if backend == "nccl":
        return device if device.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(ranks, *x.shape)``: every rank's ``x`` (the same shape on every
    rank) in mesh order, on ``x``'s device. One collective over the mesh's
    group; with one rank, ``x[None]``."""
    if not is_multiprocess(mesh):
        return x[None]
    t = x.contiguous().to(_comm_device(mesh.backend, mesh.device))
    parts = [torch.empty_like(t) for _ in mesh.ranks]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``x`` on every rank, on ``x``'s device;
    ``x`` itself is left as it was. With one rank, ``x``."""
    if not is_multiprocess(mesh):
        return x
    t = x.to(_comm_device(mesh.backend, mesh.device), copy=True)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.to(x.device)


def fetch_to_host(x, mesh: Mesh | None = None):
    """
    The full arrays on every rank, as numpy: each leaf of ``x`` (tensors
    or arrays) holds this rank's block of rows, with the same shape on
    every rank; the blocks are all-gathered in mesh order. Every leaf
    travels as raw bytes in one collective, so values arrive bit for bit.
    With one rank (or no mesh) it only converts to numpy.
    """
    leaves = [_numpy(a) for a in _leaves(x)]
    if mesh is None or not is_multiprocess(mesh):
        return _unflatten(x, leaves)
    mesh.index                                   # raises outside the mesh
    return _unflatten(x, _all_gather_rows(leaves, mesh))


def _all_gather_rows(leaves, mesh: Mesh):
    """`fetch_to_host`'s collective: the leaves' rows packed as bytes into
    one ``(rows, bytes)`` buffer, all-gathered over the mesh's group, and
    unpacked into ``(ranks * rows, ...)`` arrays of the leaves' dtypes."""
    rows = leaves[0].shape[0]
    if any(a.ndim == 0 or a.shape[0] != rows for a in leaves):
        raise ValueError("fetch_to_host needs leaves with one leading row axis")
    widths = [a.dtype.itemsize * math.prod(a.shape[1:]) for a in leaves]
    buf = np.concatenate(
        [np.ascontiguousarray(a).reshape(rows, -1).view(np.uint8)
         if w else np.zeros((rows, 0), np.uint8)
         for a, w in zip(leaves, widths)], axis=1)
    t = torch.from_numpy(buf).to(_comm_device(mesh.backend, mesh.device))
    parts = [torch.empty_like(t) for _ in mesh.ranks]
    dist.all_gather(parts, t, group=mesh.group)
    full = torch.cat(parts).cpu().numpy()
    out, lo = [], 0
    for a, w in zip(leaves, widths):
        part = np.ascontiguousarray(full[:, lo:lo + w])
        out.append(part.view(a.dtype).reshape((full.shape[0],) + a.shape[1:]))
        lo += w
    return out


def broadcast_from_process0(tree, mesh: Mesh | None = None):
    """
    Rank 0's values of a tree of arrays (numpy or scalars, the same shapes
    on every rank) on every rank: the mesh's first rank over its group, or
    rank 0 of the world without a mesh. Used for exactly-once decisions
    and default seeds. A no-op with one rank.
    """
    if mesh is not None:
        if not is_multiprocess(mesh):
            return tree
        src, group, backend, device = (mesh.ranks[0], mesh.group,
                                       mesh.backend, mesh.device)
    else:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return tree
        src, group, backend = 0, None, dist.get_backend()
        device = torch.device("cpu")
    leaves = [np.asarray(a) for a in _leaves(tree)]
    buf = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                          for a in leaves])
    t = torch.from_numpy(buf).to(_comm_device(backend, device))
    dist.broadcast(t, src, group=group)
    got = t.cpu().numpy()
    out, lo = [], 0
    for a in leaves:
        part = np.ascontiguousarray(got[lo:lo + a.nbytes])
        out.append(part.view(a.dtype).reshape(a.shape))
        lo += a.nbytes
    return _unflatten(tree, out)


def checkpoint_hit(path, mesh: Mesh | None = None) -> bool:
    """Whether ``path`` exists, decided by the mesh's first rank. Every
    rank sees every rank's answer, so that a hit some rank cannot read
    raises on all of them (multi-process resume needs the checkpoint
    directory on a filesystem that every rank reads)."""
    here = os.path.exists(path)
    if mesh is None or not is_multiprocess(mesh):
        return here
    seen = fetch_to_host(np.array([here]), mesh)
    if seen[0] and not seen.all():
        blind = [r for r, s in zip(mesh.ranks, seen) if not s]
        raise FileNotFoundError(
            f"rank {mesh.ranks[0]} has checkpoint {path} but ranks {blind} "
            "cannot read it; multi-process resume needs the checkpoint "
            "directory on a shared filesystem")
    return bool(seen[0])


def world_mesh(mesh: Mesh) -> Mesh:
    """The mesh of every rank of the world, on ``mesh``'s device and
    backend (``mesh`` itself when it spans the world)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if len(mesh.ranks) == world:
        return mesh
    return Mesh({"data": world}, tuple(range(world)), mesh.rank, mesh.device,
                None, mesh.backend)
