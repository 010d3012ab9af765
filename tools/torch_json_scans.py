#!/usr/bin/env python3
"""Time get_json_object's 2-D scans on the card, in the reference's form
and in the port's, on one chunk of the smoke's documents.

    python3 tools/torch_json_scans.py [--rows N]

The reference (``spark_rapids_jni_tpu/ops/get_json_object.py``) scans
int32 position grids with ``lax.cummax`` (escape parity), a flipped
``lax.cummin`` (next non-whitespace) and ``cumsum`` (quote parity,
depth). Their torch forms are ``torch.cummax``/``cummin`` and
``torch.cumsum`` on int32; the port's (``ops/get_json_object.py``) are
log-step ``maximum``/``minimum`` passes (``_running``) and a triangular
float32 matmul (``_running_sum``) on int16 grids.
Each pair must give the same positions; the script prints each form's
device time (CUDA events, median of 10 after two warm-ups, as
``chip_smoke.time_ms``) and the card, as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar.strings import (  # noqa: E402
    byte_matrix, max_length)
from spark_rapids_jni_tpu_torch.ops.get_json_object import (  # noqa: E402
    CHUNK_CELLS, _running, _running_sum)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=None,
                    help="rows of the chunk (default: one chunk of the "
                    "module, CHUNK_CELLS // L)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_json_scans: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    docs = chip_smoke.json_documents(dev, gen, args.rows or 1 << 21)
    L = max_length(docs)
    n = args.rows or min(CHUNK_CELLS // L, docs.size)
    mat, lens = byte_matrix(docs, L)
    mat, lens = mat[:n], lens[:n]
    inb = torch.arange(L, device=dev)[None, :] < lens[:, None]
    bsl = mat == 92
    ws = inb & ((mat == 32) | (mat == 9) | (mat == 10) | (mat == 13))
    quote = mat == 34
    forms = {}
    for name, pdt in (("reference int32", torch.int32),
                      ("port int16", torch.int16)):
        idx = torch.arange(L, dtype=pdt, device=dev)[None, :]
        nonb = torch.where(bsl, -1, idx)
        nonws = torch.where(inb & ~ws, idx, L + 1)
        if pdt == torch.int32:
            fns = {
                "escape running max": lambda x=nonb: torch.cummax(
                    x, dim=1).values,
                "next non-ws running min": lambda x=nonws: torch.cummin(
                    x.flip(1), dim=1).values.flip(1),
                "quote running count": lambda: torch.cumsum(
                    quote.to(torch.int32), 1)}
        else:
            fns = {
                "escape running max": lambda x=nonb: _running(
                    x, torch.maximum),
                "next non-ws running min": lambda x=nonws: _running(
                    x, torch.minimum, reverse=True),
                "quote running count": lambda: _running_sum(
                    quote, torch.int16)}
        forms[name] = {k: (fn(), chip_smoke.time_ms(fn, 10))
                       for k, fn in fns.items()}
    ref, port = forms["reference int32"], forms["port int16"]
    for k in ref:
        if not torch.equal(ref[k][0], port[k][0].to(torch.int32)):
            raise RuntimeError(f"{k}: the port's scan differs from the "
                               "reference form's")
    print(json.dumps({"card": chip_smoke.card_line(), "rows": n, "L": L,
                      "ms": {name: {k: v[1] for k, v in f.items()}
                             for name, f in forms.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
