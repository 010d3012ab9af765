"""Nested (LIST / STRUCT) rows: the row format's variable-width layout
extended to nested schemas.

Port of ``spark_rapids_jni_tpu/ops/nested_rows.py``. Format (a flat
schema gives the bytes of ``row_conversion``'s STRING layout):

- FIXED section: slots in a pre-order walk of the schema tree. A
  fixed-width leaf takes a slot aligned to its size; a STRING or
  LIST<fixed-width> a 4-aligned 8-byte slot (int32 byte offset from the
  row start, int32 byte length of the payload); a STRUCT has no slot of
  its own, its fields' slots follow inline.
- VALIDITY: one bit per schema node in the same walk (struct parents
  included), bit ``k % 8`` of byte ``k / 8``.
- VARIABLE section at the next 8-byte boundary: the variable-width
  leaves' payloads in walk order (a null row adds no bytes; a LIST's
  payload is its elements' little-endian bytes). Rows pad to 8 bytes.

LIST elements are fixed-width; STRUCT fields are fixed-width, STRING,
LIST or STRUCT. A null struct row keeps its children's bytes (readers
consult the parent bit). The encode is torch ops; the decode reads every
node's validity words with one launch of K3's table form
(``bitmask.pack_fields``) on the rows' validity bytes in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch

from ..columnar import Column, Table, bitmask
from ..obs import traced
from ..types import DType, TypeId, INT32, UINT8
from ..utils.errors import expects
from .cuda_kernels import as_bytes
from .row_conversion import compact_images, dense
from .row_layout import align_offset


@dataclass(frozen=True)
class TypeNode:
    """A hashable schema tree: the decode's input."""
    dtype: DType
    children: Tuple["TypeNode", ...] = ()
    field_names: Optional[Tuple[str, ...]] = None


@traced("nested_rows.type_node")
def type_node(col: Column) -> TypeNode:
    if col.dtype.id == TypeId.STRUCT:
        return TypeNode(col.dtype, tuple(type_node(c) for c in col.children),
                        col.field_names)
    if col.dtype.id == TypeId.LIST:
        elem = col.child
        expects(elem.dtype.is_fixed_width,
                "nested rows support LIST of fixed-width elements only")
        return TypeNode(col.dtype, (TypeNode(elem.dtype),))
    return TypeNode(col.dtype)


@traced("nested_rows.type_tree")
def type_tree(table: Table) -> Tuple[TypeNode, ...]:
    return tuple(type_node(c) for c in table.columns)


class NestedRowLayout:
    """Slot layout over a schema tree (see the module docstring)."""

    def __init__(self, tree: Tuple[TypeNode, ...]):
        self.tree = tuple(tree)
        self.slot_starts: List[int] = []  # per leaf, walk order
        self.leaf_kinds: List[str] = []   # "fixed" | "var"
        self.leaf_dtypes: List[DType] = []
        self.n_nodes = 0
        at = 0

        def walk(node: TypeNode):
            nonlocal at
            self.n_nodes += 1
            if node.dtype.id == TypeId.STRUCT:
                expects(len(node.children) > 0, "struct needs fields")
                for ch in node.children:
                    walk(ch)
                return
            if node.dtype.id in (TypeId.STRING, TypeId.LIST):
                at = align_offset(at, 4)
                self.slot_starts.append(at)
                self.leaf_kinds.append("var")
                self.leaf_dtypes.append(node.dtype)
                at += 8
                return
            expects(node.dtype.is_fixed_width,
                    f"nested rows do not support {node.dtype!r}")
            s = node.dtype.size_bytes
            at = align_offset(at, s)
            self.slot_starts.append(at)
            self.leaf_kinds.append("fixed")
            self.leaf_dtypes.append(node.dtype)
            at += s

        for node in self.tree:
            walk(node)
        self.validity_offset = at
        self.validity_bytes = (self.n_nodes + 7) // 8
        self.var_start = align_offset(at + self.validity_bytes, 8)
        self.has_var = "var" in self.leaf_kinds


def _leaves(col: Column, out: List[Column]) -> List[Column]:
    """Pre-order leaf columns (a STRUCT contributes its fields)."""
    if col.dtype.id == TypeId.STRUCT:
        for ch in col.children:
            _leaves(ch, out)
    else:
        out.append(col)
    return out


def _node_validity(col: Column, out: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Pre-order validity of every node, struct parents included."""
    out.append(col.valid_bool())
    if col.dtype.id == TypeId.STRUCT:
        for ch in col.children:
            _node_validity(ch, out)
    return out


def _var_byte_lens(col: Column) -> torch.Tensor:
    """int32 payload bytes of each row of a STRING/LIST column (0 for a
    null row)."""
    offs = col.offsets.data
    counts = (offs[1:] - offs[:-1]).to(torch.int32)
    esize = 1 if col.dtype.id == TypeId.STRING else col.child.dtype.size_bytes
    return torch.where(col.valid_bool(), counts * esize, 0)


def _var_byte_panel(col: Column, lens: torch.Tensor, max_bytes: int
                    ) -> torch.Tensor:
    """(N, max_bytes) uint8: each row's payload bytes, zero past them."""
    n = col.size
    dev = lens.device
    if col.dtype.id == TypeId.STRING:
        flat, esize = col.child.data, 1
    else:
        flat = as_bytes(col.child.data).reshape(-1)
        esize = col.child.dtype.size_bytes
    if max_bytes == 0 or n == 0 or flat.numel() == 0:
        return torch.zeros((n, max_bytes), dtype=torch.uint8, device=dev)
    starts = col.offsets.data[:-1].to(torch.int64) * esize
    lanes = torch.arange(max_bytes, device=dev)
    panel = flat[(starts[:, None] + lanes).clamp_(0, flat.numel() - 1)]
    return torch.where(lanes < lens[:, None], panel, 0)


def _to_row_images_nested(table: Table, max_bytes: Tuple[int, ...]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, W) uint8 row images, zero past each row's end, and (N,) int32
    row sizes; ``max_bytes`` are the variable-width leaves' widest
    payloads."""
    lay = NestedRowLayout(type_tree(table))
    n = table.num_rows
    dev = table.columns[0].device
    leaves: List[Column] = []
    for c in table.columns:
        _leaves(c, leaves)
    var_leaves = [c for c, k in zip(leaves, lay.leaf_kinds) if k == "var"]
    lens = [_var_byte_lens(c) for c in var_leaves]
    run = torch.zeros(n, dtype=torch.int32, device=dev)
    var_offs = []
    for ln in lens:
        var_offs.append(run)
        run = run + ln

    fixed = torch.zeros((n, lay.var_start), dtype=torch.uint8, device=dev)
    vi = 0
    for leaf, start, kind in zip(leaves, lay.slot_starts, lay.leaf_kinds):
        if kind == "var":
            fixed[:, start:start + 4] = as_bytes(lay.var_start + var_offs[vi])
            fixed[:, start + 4:start + 8] = as_bytes(lens[vi])
            vi += 1
        else:
            fixed[:, start:start + leaf.dtype.size_bytes] = as_bytes(leaf.data)
    valid: List[torch.Tensor] = []
    for c in table.columns:
        _node_validity(c, valid)
    fixed[:, lay.validity_offset:lay.validity_offset + lay.validity_bytes] \
        = bitmask.pack_bytes(torch.stack(valid, dim=1), lay.n_nodes)

    images = fixed
    sum_max = sum(max_bytes)
    if sum_max:
        # the leaves' zero-padded payload panels side by side, then a
        # stable per-row left-compaction of the bytes each row keeps
        block = torch.cat([_var_byte_panel(c, ln, mb) for c, ln, mb in
                           zip(var_leaves, lens, max_bytes)], dim=1)
        drop = torch.cat([torch.arange(mb, device=dev) >= ln[:, None]
                          for ln, mb in zip(lens, max_bytes)], dim=1)
        order = torch.sort(drop.to(torch.int8), dim=1, stable=True).indices
        pad = align_offset(sum_max, 8) - sum_max
        images = torch.cat([fixed, torch.gather(block, 1, order),
                            torch.zeros((n, pad), dtype=torch.uint8,
                                        device=dev)], dim=1)
    return images, lay.var_start + ((run + 7) & ~7)


@traced("nested_rows.convert_to_rows_nested")
def convert_to_rows_nested(table: Table) -> Column:
    """Nested-schema columns -> one ``list<int8>`` row column (host
    syncs: each variable-width leaf's widest payload, and the compaction
    of the row images)."""
    expects(table.num_columns > 0, "table must have at least one column")
    leaves: List[Column] = []
    for c in table.columns:
        _leaves(c, leaves)
    max_bytes = tuple(
        int(_var_byte_lens(c).max()) if c.size else 0 for c in leaves
        if c.dtype.id in (TypeId.STRING, TypeId.LIST))
    return compact_images(*_to_row_images_nested(table, max_bytes))


def _payload(child: torch.Tensor, base: torch.Tensor, off: torch.Tensor,
             ln: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 offsets (N + 1) and the concatenated payload bytes of one
    variable-width slot (host syncs: the widest payload)."""
    n = ln.shape[0]
    dev = child.device
    offs = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    torch.cumsum(ln, 0, out=offs[1:])
    max_len = int(ln.max()) if n else 0
    if not max_len:
        return offs, torch.zeros(0, dtype=torch.uint8, device=dev)
    lanes = torch.arange(max_len, device=dev)
    pos = ((base + off)[:, None] + lanes).clamp_(0, child.numel() - 1)
    return offs, child[pos][lanes < ln[:, None]]


def _rebuild(node: TypeNode, n: int, datas: Iterator, slots: Iterator,
             vwords: Iterator, child: torch.Tensor, base: torch.Tensor
             ) -> Column:
    """Column reconstruction in the layout's pre-order walk."""
    my_valid = next(vwords)
    if node.dtype.id == TypeId.STRUCT:
        children = tuple(_rebuild(ch, n, datas, slots, vwords, child, base)
                         for ch in node.children)
        return Column(node.dtype, n, None, my_valid, children=children,
                      field_names=node.field_names)
    if node.dtype.id not in (TypeId.STRING, TypeId.LIST):
        return Column(node.dtype, n, next(datas), my_valid)
    off, ln = next(slots)
    offs, payload = _payload(child, base, off, ln.clamp(min=0))
    if node.dtype.id == TypeId.STRING:
        return Column(node.dtype, n, None, my_valid, children=(
            Column(INT32, n + 1, offs),
            Column(UINT8, int(payload.shape[0]), payload)))
    elem_dt = node.children[0].dtype
    esize = elem_dt.size_bytes
    n_elems = int(payload.shape[0]) // esize
    elems = payload.view(elem_dt.to_torch())
    if elem_dt.storage_lanes == 2:
        elems = elems.reshape(n_elems, 2)
    return Column(node.dtype, n, None, my_valid, children=(
        Column(INT32, n + 1, offs // esize),
        Column(elem_dt, n_elems, elems)))


@traced("nested_rows.convert_from_rows_nested")
def convert_from_rows_nested(rows: Column, tree: Tuple[TypeNode, ...]
                             ) -> Table:
    """Nested rows -> columns, the inverse of ``convert_to_rows_nested``.
    Every node gets validity words, all of them from one K3 launch."""
    expects(rows.dtype.id == TypeId.LIST, "input must be a list column")
    lay = NestedRowLayout(tree)
    n = rows.size
    child = rows.child.data.view(torch.uint8)
    dev = child.device
    base = rows.offsets.data[:-1].to(torch.int64)
    if n:
        pos = base[:, None] + torch.arange(lay.var_start, device=dev)
        fixed = child[pos.clamp_(0, max(child.numel() - 1, 0))]
    else:
        fixed = torch.zeros((0, lay.var_start), dtype=torch.uint8,
                            device=dev)
    # every slot is aligned to its own size and rows to 8 bytes, so the
    # matrix viewed as a slot's type holds each value in one element
    datas, slots = [], []
    for dt, start, kind in zip(lay.leaf_dtypes, lay.slot_starts,
                               lay.leaf_kinds):
        if kind == "var":
            w = fixed.view(torch.int32)[:, start // 4:start // 4 + 2]
            slots.append((dense(w[:, 0]), dense(w[:, 1])))
        elif dt.storage_lanes == 2:
            datas.append(dense(
                fixed.view(torch.int64)[:, start // 8:start // 8 + 2]))
        else:
            datas.append(dense(
                fixed.view(dt.to_torch())[:, start // dt.size_bytes]))
    vwords = bitmask.pack_fields(
        fixed[:, lay.validity_offset:lay.validity_offset + lay.validity_bytes],
        lay.n_nodes)
    datas_it, slots_it, vwords_it = iter(datas), iter(slots), iter(vwords)
    return Table([_rebuild(node, n, datas_it, slots_it, vwords_it, child,
                           base) for node in tree])
