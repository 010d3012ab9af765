"""Device meshes over ``torch.distributed``.

Port of ``spark_rapids_jni_tpu/parallel/mesh.py``. The reference is one
controller driving a ``jax.sharding.Mesh``; the port is one process a
device (SPMD): every rank builds the same ``Mesh`` over
``torch.distributed.device_mesh.init_device_mesh`` and the collectives
of ``parallel/collectives.py`` run on the process group of each named
axis. On CUDA the backend is NCCL, on the CPU gloo.

Axis convention, as in the reference:

- ``"part"``: partition parallelism (one Spark executor's GPU),
- ``"replica"``: serving replicas, each holding a full copy of the data
  axis; queries shard along ``part`` inside the replica a rank belongs to,
- optional ``"intra"``: row sharding inside a partition; data then
  shards over ``(intra, part)`` jointly.

Consumers name logical axes (``"data"``, ``"replica"``, ``"intra"``) and
resolve them through ``logical_to_physical``.

A ``Mesh`` keeps the global rank of every mesh position (``ranks``, the
counterpart of the reference's ``mesh.devices``). A sub-mesh that holds
this rank (``replica_submeshes``) carries a ``DeviceMesh`` and can run
collectives; the others only describe their ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.errors import expects

PART_AXIS = "part"
REPLICA_AXIS = "replica"
INTRA_AXIS = "intra"

# Priority-ordered logical->physical axis rules (first match wins; a
# logical axis without a physical axis on the mesh at hand replicates).
DEFAULT_AXIS_RULES: "tuple[tuple[str, str], ...]" = (
    ("data", PART_AXIS),
    ("replica", REPLICA_AXIS),
    ("intra", INTRA_AXIS),
)


class Mesh:
    """Named axes over the global ranks of a process group.

    ``shape`` maps axis name -> size in axis order, ``ranks`` is the
    grid of global ranks, ``device_mesh`` the ``DeviceMesh`` when this
    rank belongs to the mesh (None for a sibling replica's sub-mesh)."""

    def __init__(self, device_type: str, axis_names: Sequence[str],
                 ranks: np.ndarray, device_mesh=None):
        self.device_type = device_type
        self.axis_names = tuple(str(a) for a in axis_names)
        self.ranks = np.asarray(ranks, dtype=np.int64)
        expects(self.ranks.ndim == len(self.axis_names),
                "one rank-grid dimension per axis name")
        self.shape = {a: int(s) for a, s in zip(self.axis_names,
                                                self.ranks.shape)}
        self.device_mesh = device_mesh
        self._subgroups: dict = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.device_type}, {self.shape}, "
                f"ranks={self.ranks.reshape(-1).tolist()})")

    @property
    def local(self) -> bool:
        """True when this rank belongs to the mesh."""
        return self.device_mesh is not None

    @property
    def device(self) -> torch.device:
        """The device this rank's tensors live on."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def _dm(self):
        expects(self.device_mesh is not None,
                f"rank {dist.get_rank()} is not part of {self!r}")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        dm = self._dm()
        if dm.ndim == 1:
            return dm.get_group()
        return dm.get_group(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        dm = self._dm()
        if dm.ndim == 1:
            return int(dm.get_local_rank())
        return int(dm.get_local_rank(axis))

    def subgroup(self, axis: str, groups) -> "tuple[object, int]":
        """The process group of this rank's block of ``groups`` along
        ``axis`` (each block lists axis coordinates, all blocks of one
        size; the ``axis_index_groups`` of the reference) and this rank's
        position in it. Every rank creates every block's group in the
        same order (``new_group`` is collective), once per mesh."""
        key = (axis, tuple(tuple(int(i) for i in g) for g in groups))
        if key not in self._subgroups:
            pos = self.axis_names.index(axis)
            lines = np.moveaxis(self.ranks, pos, -1).reshape(
                -1, self.shape[axis])
            me = dist.get_rank()
            mine = None
            for line in lines:
                for g in key[1]:
                    members = [int(line[i]) for i in g]
                    grp = dist.new_group(members)
                    if me in members:
                        mine = (grp, members.index(me))
            expects(mine is not None, f"rank {me} is in no group of {key}")
            self._subgroups[key] = mine
        return self._subgroups[key]


def logical_to_physical(
    logical_axes: Sequence[Optional[str]],
    mesh: Optional[Mesh] = None,
    rules: "tuple[tuple[str, str], ...]" = DEFAULT_AXIS_RULES,
) -> "tuple[Optional[str], ...]":
    """Resolve logical axis names to physical mesh axes by rule priority;
    axes the mesh does not carry resolve to None, and each physical axis
    is used at most once."""
    available = None if mesh is None else set(mesh.shape)
    table = dict(rules)
    out: "list[Optional[str]]" = []
    used: "set[str]" = set()
    for logical in logical_axes:
        phys = table.get(logical) if logical is not None else None
        if phys is not None and available is not None \
                and phys not in available:
            phys = None
        if phys is not None and phys in used:
            phys = None
        if phys is not None:
            used.add(phys)
        out.append(phys)
    return tuple(out)


def _device_type(device_type: Optional[str]) -> str:
    """``cuda`` unless the caller asks for another device type; without
    a GPU the default raises, like the port's other entry points."""
    if device_type is None:
        expects(torch.cuda.is_available(),
                "no CUDA device is available; pass device_type='cpu' to "
                "build a gloo mesh on the CPU")
        return "cuda"
    return str(device_type)


def make_mesh(axis_sizes: "dict[str, int]",
              device_type: Optional[str] = None) -> Mesh:
    """A mesh with named axes over ranks ``0 .. prod(sizes) - 1``, e.g.
    ``make_mesh({"part": 4}, device_type="cpu")``. Initialises the
    default process group from the environment when it is not yet
    initialised (``distributed.initialize`` does it explicitly)."""
    from torch.distributed.device_mesh import init_device_mesh
    dtype = _device_type(device_type)
    names = tuple(axis_sizes.keys())
    shape = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(shape))
    if dist.is_initialized():
        world = dist.get_world_size()
        if n > world:
            raise ValueError(f"mesh needs {n} ranks, have {world}")
    dm = init_device_mesh(dtype, shape, mesh_dim_names=names)
    ranks = np.asarray(dm.mesh.tolist(), dtype=np.int64).reshape(shape)
    return Mesh(dtype, names, ranks, dm)


def default_mesh(n: Optional[int] = None,
                 device_type: Optional[str] = None) -> Mesh:
    """1-D partition mesh over the first ``n`` (default: all) ranks."""
    return make_mesh({PART_AXIS: n if n is not None
                      else dist.get_world_size()}, device_type)


def make_mesh_2d(n_part: int, n_replica: int,
                 device_type: Optional[str] = None) -> Mesh:
    """2-D ``replica x part`` mesh, replicas outermost: each replica's
    partition group is a contiguous rank range."""
    return make_mesh({REPLICA_AXIS: int(n_replica),
                      PART_AXIS: int(n_part)}, device_type)


def make_mesh_3d(n_part: int, n_intra: int, n_replica: int = 1,
                 device_type: Optional[str] = None) -> Mesh:
    """3-D ``replica x intra x part`` mesh; data shards over
    ``(intra, part)`` (``data_axes``)."""
    return make_mesh({REPLICA_AXIS: int(n_replica),
                      INTRA_AXIS: int(n_intra),
                      PART_AXIS: int(n_part)}, device_type)


def data_axes(mesh: Mesh) -> "tuple[str, ...]":
    """The physical axes data rows shard over, outer first:
    ``(intra, part)`` on a mesh carrying both, ``(part,)`` otherwise. The
    combined shard index is row-major over this tuple
    (``collectives.axis_index_flat``)."""
    phys = logical_to_physical(("intra", "data"), mesh)
    axes = tuple(a for a in phys if a is not None)
    return axes if axes else (PART_AXIS,)


def replica_submeshes(mesh: Mesh) -> "list[Mesh]":
    """One data-axis mesh per replica slice: ``part`` sub-meshes of a
    ``replica x part`` mesh, ``intra x part`` ones of a 3-D mesh; a mesh
    without a replica axis yields itself. Only the slice holding this
    rank carries a ``DeviceMesh`` (the others describe their ranks)."""
    names = mesh.axis_names
    if REPLICA_AXIS not in names:
        return [mesh]
    r_pos = names.index(REPLICA_AXIS)
    rest = tuple(n for n in names if n != REPLICA_AXIS)
    if rest not in ((PART_AXIS,), (INTRA_AXIS, PART_AXIS)):
        raise ValueError(
            f"replica_submeshes expects a (replica, part) or "
            f"(replica, intra, part) mesh, got axes {names}")
    mine = (mesh.axis_index(REPLICA_AXIS) if mesh.local else None)
    out = []
    for i in range(mesh.shape[REPLICA_AXIS]):
        grid = np.take(mesh.ranks, i, axis=r_pos)
        dm = None
        if i == mine:
            dm = mesh.device_mesh[rest if len(rest) > 1 else rest[0]]
        out.append(Mesh(mesh.device_type, rest, grid, dm))
    return out


def mesh_axes_key(mesh: Mesh) -> tuple:
    """The mesh's layout and rank set: its (axis, size) pairs, then the
    global ranks in mesh order (two replica sub-meshes of one shape hold
    different ranks)."""
    return tuple(mesh.shape.items()) + (
        tuple(int(r) for r in mesh.ranks.reshape(-1)),)
