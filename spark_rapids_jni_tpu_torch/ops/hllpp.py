"""HyperLogLog++ (approx_count_distinct) sketches.

Port of ``spark_rapids_jni_tpu/ops/hllpp.py``, with Spark's semantics
(``HyperLogLogPlusPlus``):

- values hash with XXHash64, seed 42 (``hashing.xxhash64_column``);
- the register index is the hash's top ``p`` bits; the register keeps
  the maximum of ``rho = clz((h << p) | 1 << (p - 1)) + 1``;
- Spark's buffer layout: 6-bit registers, 10 to an int64 word (LSB
  first), ``ceil(m / 10)`` words; null values leave the sketch alone;
- the estimate is Ertl's improved raw estimator over the register
  histogram, with the reference's fixed 70 (sigma) and 64 (tau) rounds.

torch has no unsigned 64-bit arithmetic and no clz: the hash is int64
lanes holding the uint64 bits, right shifts are masked after the
arithmetic shift, and clz is a six-step binary search on those lanes.
The register maximum is one ``scatter_reduce_`` (grouped: into an
(n_groups, m) matrix).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..columnar import Column, Table
from ..obs import traced
from ..types import INT64
from ..utils.errors import expects
from .hashing import xxhash64_column

REGISTER_SIZE = 6  # bits per register (Spark's HyperLogLogPlusPlusHelper)
REGISTERS_PER_WORD = 64 // REGISTER_SIZE  # 10


@traced("hllpp.precision_for_rsd")
def precision_for_rsd(relative_sd: float = 0.05) -> int:
    """Spark: p = ceil(2 * log2(1.106 / relativeSD)), at least 4."""
    p = int(math.ceil(2.0 * math.log(1.106 / relative_sd) / math.log(2.0)))
    expects(p >= 4, f"relativeSD {relative_sd} too large (p={p} < 4)")
    return p


@traced("hllpp.num_registers")
def num_registers(precision: int) -> int:
    return 1 << precision


@traced("hllpp.num_words")
def num_words(precision: int) -> int:
    m = num_registers(precision)
    return (m + REGISTERS_PER_WORD - 1) // REGISTERS_PER_WORD


def lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1) if r else x


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the uint64 bits of nonzero int64 lanes."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = lsr64(x, 64 - s) == 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, x << s, x)
    return n


def _index_and_rho(col: Column, precision: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row (register index, rho) as int64; rho 0 for a null row (no
    update)."""
    h = xxhash64_column(col)
    idx = lsr64(h, 64 - precision)
    w = (h << precision) | (1 << (precision - 1))
    rho = clz64(w) + 1
    if col.validity is not None:
        rho = torch.where(col.valid_bool(), rho, 0)
    return idx, rho


def _pack(registers: torch.Tensor) -> torch.Tensor:
    """(..., m) registers -> (..., num_words) int64, Spark's layout:
    register j in word j // 10 at bit 6 * (j % 10)."""
    m = registers.shape[-1]
    w = (m + REGISTERS_PER_WORD - 1) // REGISTERS_PER_WORD
    regs = torch.nn.functional.pad(registers.to(torch.int64),
                                   (0, w * REGISTERS_PER_WORD - m))
    shifts = torch.arange(REGISTERS_PER_WORD, dtype=torch.int64,
                          device=regs.device) * REGISTER_SIZE
    grouped = regs.reshape(regs.shape[:-1] + (w, REGISTERS_PER_WORD))
    return (grouped << shifts).sum(dim=-1)


def _unpack(words: torch.Tensor, precision: int) -> torch.Tensor:
    """(..., num_words) int64 -> (..., m) int64 registers."""
    m = num_registers(precision)
    shifts = torch.arange(REGISTERS_PER_WORD, dtype=torch.int64,
                          device=words.device) * REGISTER_SIZE
    regs = (words[..., None] >> shifts) & 0x3F
    return regs.reshape(words.shape[:-1] + (-1,))[..., :m]


def _sigma(x: torch.Tensor) -> torch.Tensor:
    """Ertl's sigma over x = C0 / m, 70 fixed rounds."""
    xk, y, z = x * x, torch.full_like(x, 2.0), x + x * x * 1.0
    for _ in range(70):
        xk = xk * xk
        z = z + xk * y
        y = y + y
    return z


def _tau(x: torch.Tensor) -> torch.Tensor:
    """Ertl's tau over x = 1 - C_{q+1} / m, 64 fixed rounds; 0 for x in
    {0, 1}."""
    ok = (x > 0.0) & (x < 1.0)
    xk = torch.where(ok, x, 0.5)
    y, z = torch.ones_like(x), 1.0 - xk
    for _ in range(64):
        xk = torch.sqrt(xk)
        y = y * 0.5
        z = z - (1.0 - xk) ** 2 * y
    return torch.where(ok, z / 3.0, 0.0)


@traced("hllpp.reduce")
def reduce(col: Column, precision: int = 9) -> torch.Tensor:
    """One sketch over the whole column -> packed int64 (num_words,)."""
    expects(4 <= precision <= 18, "precision must be in [4, 18]")
    idx, rho = _index_and_rho(col, precision)
    regs = torch.zeros(num_registers(precision), dtype=torch.int64,
                       device=idx.device)
    return _pack(regs.scatter_reduce_(0, idx, rho, "amax"))


@traced("hllpp.merge")
def merge(sketches: Sequence[torch.Tensor], precision: int) -> torch.Tensor:
    """Union of sketches: the register maximum, packed again."""
    expects(len(sketches) > 0, "merge needs at least one sketch")
    w = num_words(precision)
    for s in sketches:
        expects(tuple(s.shape) == (w,),
                f"sketch shape {tuple(s.shape)} does not match precision "
                f"{precision} (expected ({w},))")
    regs = _unpack(torch.stack(list(sketches)), precision)
    return _pack(regs.max(dim=0).values)


def raw_estimate(sketch: torch.Tensor, precision: int) -> torch.Tensor:
    """The float64 estimate before rounding (see ``estimate``)."""
    regs = _unpack(sketch, precision)
    m = num_registers(precision)
    q = 64 - precision  # register values span 0 .. q + 1
    hist = torch.zeros(regs.shape[:-1] + (q + 2,), dtype=torch.float64,
                       device=regs.device)
    hist.scatter_add_(-1, regs, torch.ones_like(regs, dtype=torch.float64))
    c0 = hist[..., 0]
    mid = 0
    for k in range(1, q + 1):  # the reference's order of the sum
        mid = mid + hist[..., k] * (2.0 ** -k)
    z = (m * _sigma(c0 / m) + mid
         + m * _tau(1.0 - hist[..., q + 1] / m) * (2.0 ** -q))
    alpha_inf = 1.0 / (2.0 * math.log(2.0))
    return torch.where(c0 == m, 0.0, alpha_inf * m * m / z)


@traced("hllpp.estimate")
def estimate(sketch: torch.Tensor, precision: int) -> torch.Tensor:
    """Cardinality estimates of packed sketch(es) (num_words,) or
    (..., num_words) -> int64 (a scalar or (...,)). Ertl's estimator:
    alpha_inf m^2 / (m sigma(C0/m) + sum_{k=1..q} C_k 2^-k
    + m tau(1 - C_{q+1}/m) 2^-q), q = 64 - p, alpha_inf = 1 / (2 ln 2),
    rounded half to even; an empty sketch estimates 0."""
    return torch.round(raw_estimate(sketch, precision)).to(torch.int64)


@traced("hllpp.groupby_reduce")
def groupby_reduce(keys: Table, value: Column, precision: int = 9
                   ) -> Tuple[Table, torch.Tensor]:
    """Grouped sketches: one scatter-max into an (n_groups, m) register
    matrix. Returns (group keys in sorted key order, packed (n_groups,
    num_words))."""
    from .groupby import group_layout, sorted_phase
    from .sort import gather

    expects(keys.num_rows == value.size, "keys/value row count mismatch")
    gid, perm, n_groups = sorted_phase(keys)
    m = num_registers(precision)
    regs = torch.zeros((n_groups, m), dtype=torch.int64, device=perm.device)
    if n_groups == 0:
        return gather(keys, perm), _pack(regs)
    idx, rho = _index_and_rho(value, precision)
    regs.view(-1).scatter_reduce_(0, gid * m + idx[perm], rho[perm], "amax")
    head, _ = group_layout(gid, n_groups)
    return gather(keys, perm[head]), _pack(regs)


@traced("hllpp.estimate_column")
def estimate_column(sketches: torch.Tensor, precision: int) -> Column:
    """Batched estimates as an INT64 column."""
    est = estimate(sketches, precision)
    return Column(INT64, int(est.shape[0]), est)
