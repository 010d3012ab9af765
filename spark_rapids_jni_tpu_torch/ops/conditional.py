"""Conditional expressions: if_else, case_when and coalesce.

Port of ``spark_rapids_jni_tpu/ops/conditional.py`` (the mainline
CaseWhen/Nvl/coalesce GPU expressions) with Spark SQL null semantics:

- ``if_else(cond, a, b)``: rows where cond is NULL take the ELSE branch
  (a NULL predicate is not true); validity follows the chosen branch.
- ``case_when([(cond, value), ...], default)``: the first true condition
  wins, in order; no true condition gives default (NULL without one).
- ``coalesce(cols)``: the first non-null value of each row.

Each is a chain of ``torch.where`` passes. A result with a null row
gets its validity packed by ``bitmask.pack`` (K3 on the card); one with
none gets no mask (a host sync decides, as in the reference).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..columnar import Column, bitmask
from ..types import TypeId
from ..utils.errors import expects
from ..obs import traced


def _cond_true(cond: Column) -> torch.Tensor:
    expects(cond.dtype.id == TypeId.BOOL8, "condition must be BOOL8")
    return (cond.data != 0) & cond.valid_bool()


def _pick(take: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``where`` over rows; a DECIMAL128 row is two int64 lanes."""
    return torch.where(take[:, None] if a.dim() == 2 else take, a, b)


def _result(like: Column, n: int, data, valid) -> Column:
    return Column(like.dtype, n, data,
                  None if bool(valid.all()) else bitmask.pack(valid))


def _same_type(a: Column, b: Column) -> bool:
    return a.dtype.id == b.dtype.id and a.dtype.scale == b.dtype.scale


@traced("conditional.if_else")
def if_else(cond: Column, a: Column, b: Column) -> Column:
    """Row-wise IF(cond, a, b) with SQL null-predicate semantics."""
    expects(_same_type(a, b), "branch types must match")
    expects(cond.size == a.size == b.size, "size mismatch")
    take_a = _cond_true(cond)
    return _result(a, a.size, _pick(take_a, a.data, b.data),
                   torch.where(take_a, a.valid_bool(), b.valid_bool()))


@traced("conditional.case_when")
def case_when(branches: Sequence[Tuple[Column, Column]],
              default: Optional[Column] = None) -> Column:
    """CASE WHEN c1 THEN v1 WHEN c2 THEN v2 ... [ELSE default] END."""
    expects(len(branches) > 0, "need at least one WHEN branch")
    first = branches[0][1]
    n = first.size
    for c, v in branches:
        expects(_same_type(v, first), "all branch values must share a type")
        expects(c.size == n and v.size == n, "size mismatch")
    if default is not None:
        expects(_same_type(default, first), "default type must match")
        data, valid = default.data, default.valid_bool()
    else:
        data = torch.zeros_like(first.data)
        valid = torch.zeros(n, dtype=torch.bool, device=first.device)
    # fold from the last branch backward so the FIRST true condition wins
    for cond, value in reversed(list(branches)):
        take = _cond_true(cond)
        data = _pick(take, value.data, data)
        valid = torch.where(take, value.valid_bool(), valid)
    return _result(first, n, data, valid)


@traced("conditional.coalesce")
def coalesce(cols: Sequence[Column]) -> Column:
    """First non-null value per row across ``cols``."""
    expects(len(cols) > 0, "need at least one column")
    n = cols[0].size
    for c in cols:
        expects(_same_type(c, cols[0]) and c.size == n,
                "coalesce columns must share type and size")
    data, valid = cols[-1].data, cols[-1].valid_bool()
    for c in reversed(cols[:-1]):
        cv = c.valid_bool()
        data = _pick(cv, c.data, data)
        valid = cv | valid
    return _result(cols[0], n, data, valid)
