"""Device meshes, placements and collectives over mesh axes (PyTorch).

Counterpart of ``repro/launch/mesh.py``: the production mesh shapes and
axis names ((16, 16) ``("data", "model")``; (2, 16, 16) with ``"pod"``),
`batch_axes` and `row_axes`.  Importing this module touches neither a
device nor a process group; functions do.

Programming model: the reference is single-controller (one process drives
global arrays and ``shard_map`` splits them); the port is SPMD.  One
process runs per rank, each rank holds its own shard, and every rank runs
the same sequence of collective-bearing calls with the same arguments.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` under the
reference's axis names; the collectives below run on the process group of
one or more of its axes, and a world of one rank goes through the same
calls as a world of four.

Bring-up: `init_ranks` starts the process group from a
``torch.distributed.FileStore`` path (rank and world size given) or from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); `make_mesh` then lays the ranks out.  The backend is an
explicit argument: ``nccl`` (one rank per GPU) or ``gloo``.  gloo's support
for CUDA tensors differs from collective to collective, so on a gloo mesh
every collective of a CUDA tensor is staged through host memory: the tensor
is copied to the host, reduced or gathered there, and copied back.  That is
a transport choice fixed by the backend, never a compute fallback; the
copies are counted in `MeshComms`.

Threads: the groups of a mesh pair the calls of every rank in issue order,
so two threads issuing collectives on one mesh at once could pair one
thread's call on one rank with the other's on another.  `fork` gives a
mesh groups of its own (built eagerly, on the calling thread, in the same
order on every rank), and a collective handed the fork runs on them.  The
serving engine takes a fork per engine and hands it to its search, its
cache gathers and its agreements, so the replicas of a router, each
stepping on its own thread, never pair their calls; `release` frees a
fork's groups.  `broadcast_object` and `gather_objects` carry small host
objects (a batch's makeup, stage outcomes) over every rank of a mesh.

Faults: a collective that fails (a rank fell out, the group's timeout ran
out) raises `MeshError`, and ranks that find they have parted ways raise
its subclass `MeshDivergence`.  Both are fatal on every rank: a caller
never takes one for the fault of a single request.

Pipelines: `ppermute` sends a tensor one hop along a mesh axis, and its
backward sends the cotangent back (JAX's transpose of ``ppermute``).

Placements: a `ShardSpec` (the port's own small type, not DTensor's
per-mesh-dimension ``Shard``/``Replicate`` tuple) gives, for each tensor
dimension, the mesh axes it is split over, as the reference's
``PartitionSpec`` does entry for entry.  `local_slice` cuts a rank's block
out of a full tensor and `gather_full` reassembles it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the reference's production mesh: 256 chips
    as (16, 16) ``("data", "model")``, 512 as (2, 16, 16) with ``"pod"``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None,
                         backend: str = "nccl"):
    """The production mesh over an already started world of 256 (512)
    ranks (`init_ranks`)."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device=device, backend=backend)


def batch_axes(mesh) -> tuple:
    """Axes that carry data parallelism (pod extends data)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def row_axes(mesh) -> tuple:
    """All axes, for corpus/embedding-table row sharding."""
    return tuple(mesh.mesh_dim_names)


class MeshError(RuntimeError):
    """A collective over a mesh failed: a rank fell out or the group's
    timeout ran out.  Fatal on every rank."""


class MeshDivergence(MeshError):
    """The ranks of a mesh parted ways: a step failed on some ranks and
    not on others, or the ranks reached different steps.  Raised on every
    rank of the parted group instead of results that would differ."""


@contextlib.contextmanager
def _collective(what: str):
    """Re-raise a failure of the ``torch.distributed`` call inside as
    `MeshError`."""
    try:
        yield
    except MeshError:
        raise
    except Exception as e:                 # noqa: BLE001 — typed as fatal
        raise MeshError(f"{what} failed: {type(e).__name__}: {e}") from e


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------

def init_ranks(backend: str, *, store_path=None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = 600.0) -> tuple:
    """Start this process's rank; returns (rank, world size).

    With ``store_path`` the ranks rendezvous through a ``FileStore`` at that
    path (``rank`` and ``world_size`` required; the file must not be left
    over from an earlier world).  Without it, through ``torchrun``'s
    environment variables (``env://``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    global _timeout
    if dist.is_initialized():
        raise RuntimeError("a process group is already running here")
    timeout = _timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore rendezvous needs rank and "
                             "world_size")
        store = dist.FileStore(str(store_path), int(world_size))
        dist.init_process_group(backend, store=store, rank=int(rank),
                                world_size=int(world_size), timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


# the world's collective timeout (`init_ranks`), given to every group this
# module makes, so a collective that waits on a rank that never comes
# fails within it
_timeout: Optional[datetime.timedelta] = None


def shutdown() -> None:
    """Tear down the process group `init_ranks` started."""
    global _timeout
    _timeout = None
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class MeshComms:
    """What the port's collectives need beside the ``DeviceMesh``: the
    backend, the ranks' device, the process group of each axis tuple used
    so far, and the host copies a gloo mesh makes for CUDA tensors."""

    backend: str
    device: torch.device
    groups: dict = dataclasses.field(default_factory=dict)
    # a fork's gloo group over every rank for host objects, apart from
    # the groups that carry tensors
    control: Optional[object] = None
    host_copies: int = 0          # device -> host and host -> device copies
    host_bytes: int = 0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def count_copy(self, t: torch.Tensor) -> None:
        with self._lock:
            self.host_copies += 1
            self.host_bytes += t.numel() * t.element_size()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike, backend: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the running world
    (`init_ranks` with the same ``backend``), its ranks computing on
    ``device`` (``cuda``/``cuda:i`` or ``cpu``).  The mesh carries a
    `MeshComms` as ``mesh.repro_comms``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("start the ranks first (init_ranks)")
    if dist.get_backend() != backend:
        raise ValueError(f"the world runs {dist.get_backend()!r}, the mesh "
                         f"asks for {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl needs CUDA devices")
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ "
                         f"in length")
    if dev.type == "cuda":
        # before the mesh, so DeviceMesh does not pick a device itself
        torch.cuda.set_device(dev)
    mesh = init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))
    mesh.repro_comms = MeshComms(backend=backend, device=dev)
    return mesh


class Fork:
    """A mesh over the same ranks, axes and device as ``base`` (a
    `make_mesh` mesh) that holds process groups of its own (`fork`)."""

    def __init__(self, base, comms: MeshComms):
        self.base = base
        self.mesh = base.mesh
        self.mesh_dim_names = base.mesh_dim_names
        self.repro_comms = comms

    def size(self, dim: int) -> int:
        return self.base.size(dim)

    def get_local_rank(self, dim: int) -> int:
        return self.base.get_local_rank(dim)


def fork(mesh, axes_list: Sequence = ()) -> Fork:
    """A mesh over the same ranks and device as ``mesh`` with process groups
    of its own: the group over every axis, a gloo group over every axis for
    host objects, and the groups over each tuple in ``axes_list``, all
    built now (``new_group`` is collective over the world: every rank
    forks in the same order, on one thread).  Collectives handed the fork
    run on its groups; `release` frees them."""
    base = getattr(mesh, "base", mesh)
    comms = _comms(base)
    out = Fork(base, MeshComms(backend=comms.backend, device=comms.device))
    _, block = axes_group(out, row_axes(base))
    with _collective("new_group"):
        out.repro_comms.control = dist.new_group(ranks=block, backend="gloo",
                                                 timeout=_timeout)
    for axes in axes_list:
        axes_group(out, axes)
    return out


def release(forked: Fork) -> None:
    """Free the process groups of ``forked`` (`fork`) once every rank has
    reached this call (collective); the fork takes no collective after."""
    comms = _comms(forked)
    if comms.control is None:
        return
    barrier(forked)
    groups = [got[0] for got in comms.groups.values() if got is not None]
    for group in groups + [comms.control]:
        dist.destroy_process_group(group)
    comms.groups.clear()
    comms.control = None


def _comms(mesh) -> MeshComms:
    comms = getattr(mesh, "repro_comms", None)
    if comms is None:
        raise ValueError("not a mesh of make_mesh (no repro_comms)")
    return comms


def _axis_dims(mesh, axes) -> list:
    names = tuple(mesh.mesh_dim_names)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(set(axes)) != len(axes) or any(a not in names for a in axes):
        raise ValueError(f"axes {axes} are not distinct axes of {names}")
    return [names.index(a) for a in axes]


def axes_size(mesh, axes) -> int:
    """Ranks along ``axes`` (1 for no axes)."""
    return math.prod(mesh.size(d) for d in _axis_dims(mesh, axes))


def axes_position(mesh, axes) -> int:
    """This rank's linearized position over ``axes``, the first axis
    outermost (the reference's ``axis_index`` loop)."""
    pos = 0
    for d in _axis_dims(mesh, axes):
        pos = pos * mesh.size(d) + mesh.get_local_rank(d)
    return pos


def axes_group(mesh, axes) -> tuple:
    """(process group over ``axes`` holding this rank, global ranks of the
    group's members in position order).  Built on first use by every rank
    of the world, in the same order (``new_group`` is collective), as the
    mesh's own: never a group of another mesh or fork."""
    comms = _comms(mesh)
    dims = _axis_dims(mesh, axes)
    key = tuple(dims)
    got = comms.groups.get(key)
    if got is not None:
        return got
    rest = [d for d in range(mesh.mesh.ndim) if d not in dims]
    blocks = mesh.mesh.permute(*rest, *dims).reshape(-1, axes_size(mesh, axes))
    me = dist.get_rank()
    mine = None
    for block in blocks.tolist():
        with _collective("new_group"):
            group = dist.new_group(ranks=block, timeout=_timeout)
        if me in block:
            mine = (group, block)
    comms.groups[key] = mine
    return mine


def _to_host(comms: MeshComms, t: torch.Tensor) -> torch.Tensor:
    if not comms.staged or t.device.type != "cuda":
        return t
    comms.count_copy(t)
    return t.cpu()


def _back(comms: MeshComms, host: torch.Tensor, like: torch.Tensor):
    if host.device == like.device:
        return host
    comms.count_copy(host)
    return host.to(like.device)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced (``sum`` or ``max``) over the ranks
    along ``axes``."""
    comms = _comms(mesh)
    group, _ = axes_group(mesh, axes)
    buf = _to_host(comms, t.detach()).clone(
        memory_format=torch.contiguous_format)
    with _collective("all_reduce"):
        dist.all_reduce(buf, op=_OPS[op], group=group)
    return _back(comms, buf, t)


def all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` along ``axes``, stacked in
    position order."""
    comms = _comms(mesh)
    group, block = axes_group(mesh, axes)
    src = _to_host(comms, t.detach().contiguous())
    parts = [torch.empty_like(src) for _ in block]
    with _collective("all_gather"):
        dist.all_gather(parts, src, group=group)
    # group ranks follow global ranks; put each at its mesh position
    order = [block.index(dist.get_global_rank(group, j))
             for j in range(len(block))]
    placed = [None] * len(block)
    for j, pos in enumerate(order):
        placed[pos] = parts[j]
    return _back(comms, torch.stack(placed), t)


def broadcast(t: torch.Tensor, mesh) -> torch.Tensor:
    """A new tensor: the ``t`` of the mesh's first rank, on every rank."""
    comms = _comms(mesh)
    group, block = axes_group(mesh, row_axes(mesh))
    buf = _to_host(comms, t.detach()).clone(
        memory_format=torch.contiguous_format)
    with _collective("broadcast"):
        dist.broadcast(buf, src=block[0], group=group)
    return _back(comms, buf, t)


def _object_group(mesh) -> tuple:
    """(group, ranks in position order) for host objects over every rank:
    a fork's control group, else the group of every axis."""
    group, block = axes_group(mesh, row_axes(mesh))
    control = _comms(mesh).control
    return (group if control is None else control), block


def broadcast_object(obj, mesh):
    """The mesh's first rank's ``obj`` (picklable), on every rank."""
    group, block = _object_group(mesh)
    box = [obj]
    with _collective("broadcast_object"):
        dist.broadcast_object_list(box, src=block[0], group=group)
    return box[0]


def gather_objects(obj, mesh) -> list:
    """Every rank's ``obj`` (picklable), in mesh position order."""
    group, block = _object_group(mesh)
    parts = [None] * len(block)
    with _collective("gather_objects"):
        dist.all_gather_object(parts, obj, group=group)
    placed = [None] * len(block)
    for j, part in enumerate(parts):
        placed[block.index(dist.get_global_rank(group, j))] = part
    return placed


def barrier(mesh) -> None:
    """Wait until every rank of the mesh has reached this call."""
    comms = _comms(mesh)
    all_reduce(torch.zeros(1, device=comms.device), mesh, row_axes(mesh))


def _send_hop(t: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """Send ``t`` ``shift`` positions along ``axis`` (a ring) and return
    what arrives from ``-shift`` positions (same shape and dtype)."""
    comms = _comms(mesh)
    group, block = axes_group(mesh, (axis,))
    n = len(block)
    if n == 1:
        return t.detach().clone()
    pos = block.index(dist.get_rank())
    src = _to_host(comms, t.detach().contiguous())
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, block[(pos + shift) % n], group),
           dist.P2POp(dist.irecv, buf, block[(pos - shift) % n], group)]
    with _collective("ppermute"):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(comms, buf, t)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _send_hop(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, grad):
        return _send_hop(grad, ctx.mesh, ctx.axis, -ctx.shift), None, None, \
            None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1):
    """``x`` sent ``shift`` hops along mesh axis ``axis`` (a ring: position
    p sends to p + shift and receives from p - shift, modulo the axis
    size), as ``jax.lax.ppermute`` with the pairs ``(i, (i + shift) % n)``.
    Differentiable: the backward sends the cotangent the reverse way.  On a
    gloo mesh a CUDA tensor goes through host memory (counted in
    `MeshComms`)."""
    return _Ppermute.apply(x, mesh, axis, int(shift))


class _AllReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axes), None, None


def all_reduce_fwd(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes`` forward, identity backward: for partial results
    whose sum every rank then uses the same way (its cotangent is already
    replicated, so summing it again would count it once per rank)."""
    return _AllReduceForward.apply(x, mesh, axes)


def all_reduce_bwd(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity forward, sum over ``axes`` backward: where a replicated
    tensor enters computations that each rank does on its own part, so its
    gradient is the sum of the parts' gradients."""
    return _AllReduceBackward.apply(x, mesh, axes)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Placement of one tensor on a mesh: ``dims[i]`` holds the mesh axes
    tensor dimension ``i`` is split over (outermost first; ``()`` where it
    is whole), entry for entry the reference's ``PartitionSpec``.  A spec
    may be shorter than the tensor's rank: the dimensions after it are
    whole."""

    dims: tuple

    @classmethod
    def of(cls, *entries) -> "ShardSpec":
        """From ``PartitionSpec``-style entries: ``None``, an axis name or
        a tuple of axis names."""
        norm = []
        for e in entries:
            if e is None:
                norm.append(())
            elif isinstance(e, str):
                norm.append((e,))
            else:
                norm.append(tuple(e))
        return cls(tuple(norm))


def local_slice(full: torch.Tensor, mesh, spec: ShardSpec) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a contiguous copy)."""
    out = full
    for d, axes in enumerate(spec.dims):
        if not axes:
            continue
        n = axes_size(mesh, axes)
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        chunk = out.shape[d] // n
        out = out.narrow(d, axes_position(mesh, axes) * chunk, chunk)
    return out.contiguous().clone()


def gather_full(local: torch.Tensor, mesh, spec: ShardSpec) -> torch.Tensor:
    """The whole tensor from every rank's `local_slice` (collective)."""
    out = local
    for d, axes in enumerate(spec.dims):
        if axes:
            out = torch.cat(list(all_gather(out, mesh, axes)), dim=d)
    return out


__all__ = ["BACKENDS", "production_mesh_shape", "make_production_mesh",
           "batch_axes", "row_axes", "init_ranks", "shutdown", "MeshComms",
           "make_mesh", "axes_size", "axes_position", "axes_group",
           "all_reduce", "all_gather", "broadcast", "broadcast_object",
           "gather_objects", "barrier", "MeshError", "MeshDivergence",
           "Fork", "fork", "release", "ppermute", "all_reduce_fwd",
           "all_reduce_bwd", "ShardSpec", "local_slice", "gather_full"]
