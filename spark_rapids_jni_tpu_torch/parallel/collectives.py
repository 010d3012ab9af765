"""Raw collective primitives: the transport layer's only home.

Port of ``spark_rapids_jni_tpu/parallel/collectives.py`` to
``torch.distributed``. Each function runs one collective (or, over a
tuple of axes, one a axis) on the process group of a mesh axis:

| reference (inside ``shard_map``) | port (one process a device) |
|---|---|
| ``lax.all_to_all`` | ``all_to_all_single`` |
| ``lax.all_gather(tiled=True)`` | ``all_gather_into_tensor`` |
| ``lax.psum_scatter(tiled=True)`` | ``reduce_scatter_tensor`` |
| ``lax.psum`` / ``pmin`` / ``pmax`` | ``all_reduce`` |
| ``lax.axis_index`` | the ``DeviceMesh`` coordinate (a host int) |

(``all_gather_single`` and ``reduce_scatter_single`` where torch has
them: the same collectives under their newer names.)

Every rank must reach every collective in the same order with tensors
of the same shape: a collective one rank skips hangs the others. So
whatever decides whether, how often and at which size a collective
runs is decided from facts every rank shares (the global inputs'
verified stats, static shapes, or a count agreed by a collective).

Neither NCCL nor every gloo build reduces or exchanges ``bool``, so
bools travel as ``uint8`` and come back as ``bool``; callers that merge
presence send it as int32, as the reference does.

Tuple-axis convention (unchanged): a mesh whose data rows shard over
several axes names them outer first; the combined shard index is
row-major over the tuple, and every fold below concatenates or scatters
in exactly that order, so a tuple-axis result equals the same collective
over one flat axis of the product size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.errors import expects
from .mesh import Mesh

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

# newer torch names the two tensor collectives *_single and deprecates
# the older names, which older torch has alone
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _axes(axis) -> "tuple[str, ...]":
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _wire(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bool) if like.dtype == torch.bool else x


def axis_size(mesh: Mesh, axis) -> int:
    """The number of shards along ``axis`` (a product over a tuple)."""
    n = 1
    for ax in _axes(axis):
        n *= mesh.axis_size(ax)
    return n


def axis_index_flat(axis, mesh: Mesh) -> int:
    """This rank's shard index along ``axis``, row-major over a tuple."""
    idx = None
    for ax in _axes(axis):
        i = mesh.axis_index(ax)
        idx = i if idx is None else idx * mesh.axis_size(ax) + i
    expects(idx is not None, "axis_index_flat needs at least one axis")
    return idx


def all_to_all_blocks(x: torch.Tensor, axis: str, mesh: Mesh,
                      group=None) -> torch.Tensor:
    """Send block ``i`` of ``x`` (leading dim = the shard count) to shard
    ``i``; block ``j`` of the result is shard ``j``'s block for this
    shard. ``group`` overrides the axis's group (neighbourhoods)."""
    if group is None:
        group = mesh.group(axis)
    send = _wire(x)
    recv = torch.empty_like(send)
    if send.numel():
        dist.all_to_all_single(recv, send, group=group)
    return _back(recv, x)


def _gather_one(x: torch.Tensor, ax: str, mesh: Mesh) -> torch.Tensor:
    p = mesh.axis_size(ax)
    send = _wire(x)
    out = torch.empty((p * send.shape[0],) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    if send.numel():
        _ALL_GATHER(out, send, group=mesh.group(ax))
    return _back(out, x)


def all_gather_rows(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """Concatenate every shard's rows in shard order on every shard. A
    tuple axis folds innermost axis first, which lands the rows in
    row-major shard order (``axis_index_flat``)."""
    for ax in reversed(_axes(axis)):
        x = _gather_one(x, ax, mesh)
    return x


def reduce_scatter_sum(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """Sum per-shard ``(width, ...)`` partials and hand shard ``i`` slice
    ``[i * width/p, (i+1) * width/p)`` (width divides by the shard count;
    callers pad with zeros). A tuple axis folds outer axis first, which
    hands shard (i, j) slice ``i * size(inner) + j``."""
    for ax in _axes(axis):
        p = mesh.axis_size(ax)
        width = int(x.shape[0])
        expects(width % p == 0, "reduce-scatter width must divide the axis")
        send = x.contiguous()
        out = torch.empty((width // p,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        if send.numel():
            _REDUCE_SCATTER(out, send, op=dist.ReduceOp.SUM,
                            group=mesh.group(ax))
        x = out
    return x


def reduce_scatter_extreme(x: torch.Tensor, axis, op: str,
                           mesh: Mesh) -> torch.Tensor:
    """min/max reduce-scatter as the reference lowers it: one all_to_all
    of the owners' slices, then the min or max over the senders. Same
    ownership layout as ``reduce_scatter_sum``."""
    expects(op in ("min", "max"), f"unknown reduce op {op!r}")
    for ax in _axes(axis):
        p = mesh.axis_size(ax)
        width = int(x.shape[0])
        expects(width % p == 0, "reduce-scatter width must divide the axis")
        recv = all_to_all_blocks(
            x.reshape((p, width // p) + tuple(x.shape[1:])), ax, mesh)
        x = recv.amin(dim=0) if op == "min" else recv.amax(dim=0)
    return x


def all_reduce(x: torch.Tensor, axis, mesh: Mesh,
               op: str = "sum") -> torch.Tensor:
    """The reference's ``psum``/``pmin``/``pmax``: the reduction of every
    shard's ``x`` on every shard (a tuple axis reduces over each axis in
    turn, which reduces over their product). Returns a new tensor."""
    expects(op in _OPS, f"unknown reduce op {op!r}")
    expects(x.dtype != torch.bool, "reduce bools as integers")
    out = x.reshape(-1).clone()
    if out.numel():
        for ax in _axes(axis):
            dist.all_reduce(out, op=_OPS[op], group=mesh.group(ax))
    return out.reshape(x.shape)
