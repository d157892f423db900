"""``row_fetch`` over a sweep of launch geometries, on the card.

    python -m yolort_tpu_torch.experiments.fetch_block_sweep [--batch 128] [--seed 0]

The counterpart of ``tools/experiments/fetch_block_sweep.py``.  The TPU
script swept the VMEM blocks of its byte-plane fetch (slots x table rows);
those mean nothing on a GPU, where a block owns a run of 32 output
slots and copies each distinct row they name, so this sweeps the launch
geometry of ``row_fetch_p``: warps per block (sharing the run's rows) x
rows a warp keeps in flight (``GEOMETRIES``; ``row_fetch`` itself runs
``row_fetch_geometry``'s, from the grid).  Shapes are the script's two
fetches at batch 128:

  * stage 2: the (2565, 128) float32 chunk table, k = 4096 sorted indices
    (512-byte rows, 16-byte copies);
  * cells: the (8400, 255) bfloat16 cells table of yolov5s @640, k = 4104
    indices in two sorted runs of 3500 and 604, as the JAX package's
    ``cell_gather='pallas'`` route fetches them (510-byte rows, which no
    vector wider than 2 bytes divides; the port's postprocess gathers the
    cells with ``torch.gather``).

Inputs are drawn on the card from a seeded ``torch.Generator`` (the cells
table is 548 MB at batch 128).  Each geometry is first held bit-identical
to ``row_fetch_reference``, then timed: CUDA events over back-to-back
launches, the profiler's device time with the L2 cache warm and with it
flushed before each launch (cold), beside the bound (indices, the
distinct rows read once, the output written once, at the card's memory
rate), the plain version and ``torch.gather``, the library call that
computes the same rows.  Every time printed carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from yolort_tpu_torch.experiments.timing import (
    abs_err, bound, card_line, cold_ms, device_profile, distinct_rows, fmt_ms, median_ms,
    require_cuda, same_bits,
)
from yolort_tpu_torch.ops.cuda.lookup_kernel import row_fetch_p, row_fetch_reference

BATCH = 128
STAGE2 = (2565, 128, 4096)  # (rows, width, k), float32
CELLS = (8400, 255, 4104, 3500)  # (rows, width, k, first sorted run), bfloat16
# (warps per block, slots a warp copies with all their rows in flight)
GEOMETRIES = tuple((w, r) for w in (1, 2, 4, 8, 16, 32) for r in (1, 2, 4, 8))
LABELS = {"stage2": "stage-2 (2565,128) f32 k=4096 sorted",
          "cells": "cells (8400,255) bf16 k=4104 in two sorted runs"}


def make_inputs(batch: int, device, seed: int = 0) -> dict:
    """{'stage2' | 'cells': (table, idx int32)}, the two shapes of
    ``LABELS``, drawn from ``torch.Generator(seed)`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def sorted_idx(m, n):
        return torch.randint(0, m, (batch, n), generator=gen, device=device).sort(1).values

    m1, w1, k1 = STAGE2
    tab1 = torch.randn(batch, m1, w1, generator=gen, device=device)
    idx1 = sorted_idx(m1, k1).to(torch.int32)
    m2, w2, k2, run = CELLS
    tab2 = torch.randn(batch, m2, w2, generator=gen, device=device, dtype=torch.bfloat16)
    idx2 = torch.cat([sorted_idx(m2, run), sorted_idx(m2, k2 - run)], 1).to(torch.int32)
    return {"stage2": (tab1, idx1.contiguous()), "cells": (tab2, idx2.contiguous())}


def check(tab: torch.Tensor, idx: torch.Tensor, geometries=GEOMETRIES, label: str = "") -> float:
    """Every geometry bit-identical to ``row_fetch_reference`` (NaN
    positions compared as NaN).  Raises AssertionError; returns the largest
    absolute difference seen (0.0 when all agree)."""
    want = row_fetch_reference(tab, idx)
    err = 0.0
    for g in geometries:
        got = row_fetch_p(tab, idx, *g)
        if not same_bits(got, want):
            raise AssertionError(f"row_fetch_p {g} {label}: differs from the plain version")
        err = max(err, abs_err(got, want))
    return err


def measure(tab: torch.Tensor, idx: torch.Tensor, card: str, geometries=GEOMETRIES,
            label: str = "", tag: str = "[sweep]") -> dict:
    """The plain version, ``torch.gather`` and each geometry timed (events,
    device and cold-L2 device), beside the bound.  Prints one line each; returns
    {'bound': (ms, by), 'plain': {...}, 'library': {...}, (w, r): {...}}."""
    bsz, m, w = tab.shape
    k = idx.shape[1]
    row_bytes = w * tab.element_size()
    res = {"bound": bound(bsz * k * 4 + distinct_rows(idx, m) * row_bytes + bsz * k * row_bytes)}
    gidx = idx.long().clamp(0, m - 1)[..., None].expand(-1, -1, w)
    for name, call, n in (("plain", lambda: row_fetch_reference(tab, idx), 5),
                          ("library", lambda: torch.gather(tab, 1, gidx), 20)):
        res[name] = dict(ms=median_ms(call, n), device_ms=device_profile(call)[0],
                         cold_ms=cold_ms(call))
    bms, bby = res["bound"]
    print(f"{tag} B={bsz} {label}: bound {bms:.4f} ms ({bby}); plain {res['plain']['ms']:.4f} ms "
          f"(device {fmt_ms(res['plain']['device_ms'])}, cold {fmt_ms(res['plain']['cold_ms'])}); "
          f"torch.gather {res['library']['ms']:.4f} ms (device {fmt_ms(res['library']['device_ms'])}, "
          f"cold {fmt_ms(res['library']['cold_ms'])}) | {card}", flush=True)
    for g in geometries:
        run = lambda g=g: row_fetch_p(tab, idx, *g)  # noqa: E731
        res[g] = dict(ms=median_ms(run), device_ms=device_profile(run, kernels_per_call=1)[0],
                      cold_ms=cold_ms(run))
        print(f"{tag} B={bsz} {label} warps/block {g[0]:>2} rows/warp {g[1]}: {res[g]['ms']:.4f} ms "
              f"(device {fmt_ms(res[g]['device_ms'])}, cold {fmt_ms(res[g]['cold_ms'])}) | {card}",
              flush=True)
    # ranked by device time, or by events where the profiler measured none
    by = "device_ms" if all(res[g]["device_ms"] is not None for g in geometries) else "ms"
    best = min(geometries, key=lambda g: res[g][by])
    print(f"{tag} B={bsz} {label}: fastest geometry by {'device time' if by == 'device_ms' else 'events'} "
          f"{best} {res[best][by]:.4f} ms (cold {fmt_ms(res[best]['cold_ms'])}) | {card}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH, help="images (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0, help="input seed (default: %(default)s)")
    args = ap.parse_args(argv)
    device = require_cuda("fetch_block_sweep")
    card = card_line()
    for name, (tab, idx) in make_inputs(args.batch, device, args.seed).items():
        label = LABELS[name]
        check(tab, idx, label=label)
        print(f"[sweep] B={args.batch} {label}: all {len(GEOMETRIES)} geometries bit-identical to "
              f"the plain version | {card}", flush=True)
        measure(tab, idx, card, label=label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
