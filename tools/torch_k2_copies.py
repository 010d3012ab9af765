#!/usr/bin/env python3
"""K2's shared-memory copies against the slot width, on the card.

    python3 tools/torch_k2_copies.py [--rows N] [--out FILE]

``csrc/ragged_groupby.cu`` keeps ``copies`` copies of the slots in each
block's shared memory (warp w adds into copy w % copies, or with 1024
each thread into its own), as many as ``cuda_kernels.ragged_copies``
picks. This times the kernel (``chip_smoke.time_ms``: CUDA events,
median of 10 after two warm-ups) at each width and each copy count that
fits, on 10M rows like ``chip_smoke``'s K2 stress case (20% dead, a few
out-of-range slots, values near +-2^63), with slots spread evenly and with
nine rows in ten on two slots, each result held against the plain
version. It needs a CUDA device and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

WIDTHS = (1, 10, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
COPIES = (1, 2, 4, 8, 16, 32, 1024)
SMEM_LIMIT = 227 * 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_copies: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    K = cs.K
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    n = args.rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    mag = torch.randint(2**62, 2**63 - 1, (n,), generator=gen, device=dev)
    values = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                         -mag, mag)
    live = torch.rand(n, generator=gen, device=dev) > 0.2
    blocks = max(1, min(K._ragged_max_blocks(0),
                        -(-n // K.RAGGED_BLOCK_ROWS)))
    lib = K.kernels()
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for width in WIDTHS:
        spread = torch.randint(-8, width + 8, (n,), generator=gen,
                               device=dev, dtype=torch.int32)
        hot = torch.randint(0, min(2, width), (n,), generator=gen,
                            device=dev, dtype=torch.int32)
        skewed = torch.where(torch.rand(n, generator=gen, device=dev) < 0.9,
                             hot, spread)
        ws = torch.empty(blocks * width * 12, dtype=torch.uint8, device=dev)
        sums = torch.empty(width, dtype=torch.int64, device=dev)
        counts = torch.empty(width, dtype=torch.int32, device=dev)
        for name, slots in (("spread", spread), ("skewed", skewed)):
            want = K.ragged_groupby_sum_count_plain(slots, live, values,
                                                    width)
            row = {"width": width, "slots": name, "ms": {}}
            for copies in COPIES:
                if copies * width * 12 > SMEM_LIMIT:
                    continue

                def call(copies=copies, slots=slots):
                    rc = lib.srt_ragged_groupby_sum_count(
                        slots.data_ptr(), live.data_ptr(),
                        values.data_ptr(), n, width, copies, blocks,
                        ws.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                        stream)
                    K._check(rc, "ragged_groupby_sum_count")
                call()
                torch.cuda.synchronize()
                if not (torch.equal(sums, want[0])
                        and torch.equal(counts, want[1])):
                    raise RuntimeError(f"K2 at width {width} with {copies} "
                                       "copies differs from its plain "
                                       "version")
                row["ms"][copies] = cs.time_ms(call, cs.REPS)
            best = min(row["ms"], key=row["ms"].get)
            row["picked"] = K.ragged_copies(width)
            print(f"{n} rows, width {width:5d} {name:6s}: " + " ".join(
                f"{c}:{t:.4f}" for c, t in row["ms"].items())
                + f"  best {best}, picked {row['picked']} copies [{card}]",
                flush=True)
            results.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": n, "blocks": blocks,
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
