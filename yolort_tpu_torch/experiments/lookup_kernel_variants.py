"""Where ``lookup_fetch``'s time goes on the card, by its stripped variants.

    python -m yolort_tpu_torch.experiments.lookup_kernel_variants [--batch 128] [--seed 0]

The counterpart of ``tools/experiments/lookup_kernel_variants.py``: the
five variants of ``ops.cuda.lookup_kernel.VARIANTS`` (full; no boundary
search; no row fetch; fetch only; lookup only) on that script's inputs:
batch 128, a (2565, 128) float32 chunk table, and the exclusive offsets of
random gt-tier counts 0-3 per chunk followed by four eq-tier chunks of one
entry, k = 4096 slots.  Inputs are drawn on the card from a seeded
``torch.Generator``.  Each variant is first held bit-identical to its
plain version (and ``full`` to ``lookup_fetch``), then timed: CUDA events
over back-to-back launches, the profiler's device time with the L2
cache warm and with it flushed before each launch (cold), beside its
bound (bytes read once and written once at the card's memory rate) and
the PyTorch calls that do a part of the work (``torch.searchsorted``, the
lookup; ``torch.gather``, the row fetch).  The TPU script subtracted the
round trip of its remote device; events time the card itself, so nothing
is subtracted here.  Every time printed carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from yolort_tpu_torch.experiments.timing import (
    abs_err, bound, card_line, cold_ms, device_profile, distinct_rows, fmt_ms, fmt_share,
    median_ms, require_cuda, same_bits,
)
from yolort_tpu_torch.ops.cuda.lookup_kernel import (
    CHUNK, VARIANTS, lookup_fetch, lookup_fetch_variant, lookup_fetch_variant_reference,
)

BATCH, NC, K = 128, 2565, 4096  # the TPU script's shapes


def make_inputs(batch: int, device, seed: int = 0):
    """(table (B, 2565, 128) f32, off (B, 5130) i32): the TPU script's
    inputs, drawn from ``torch.Generator(seed)`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn(batch, NC, CHUNK, generator=gen, device=device)
    cnt_gt = torch.randint(0, 4, (batch, NC), generator=gen, device=device, dtype=torch.int32)
    cnt_eq = torch.zeros(batch, NC, dtype=torch.int32, device=device)
    cnt_eq[:, torch.randint(0, NC, (4,), generator=gen, device=device)] = 1
    cnt = torch.cat([cnt_gt, cnt_eq], 1)
    return tab, (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()


def check(tab: torch.Tensor, off: torch.Tensor, k: int, label: str = "") -> float:
    """Every variant bit-identical to its plain version (NaN positions
    compared as NaN; p and is_eq None where the variant writes neither),
    and ``full`` to ``lookup_fetch``.  Raises AssertionError; returns the
    largest absolute difference seen (0.0 when all agree)."""
    err = 0.0
    for variant in VARIANTS:
        got = lookup_fetch_variant(tab, off, k, variant)
        want = lookup_fetch_variant_reference(tab, off, k, variant)
        for name, a, b in zip(("rows", "phys", "p", "is_eq"), got, want):
            if (a is None) != (b is None) or (a is not None and not same_bits(a, b)):
                raise AssertionError(f"lookup_fetch_variant {variant} {label}: {name} differs from "
                                     f"the plain version")
            if a is not None:
                err = max(err, abs_err(a, b))
        if variant == "full" and not all(same_bits(a, b) for a, b in zip(got, lookup_fetch(tab, off, k))):
            raise AssertionError(f"lookup_fetch_variant full {label}: differs from lookup_fetch")
    return err


def variant_bytes(variant: str, phys: torch.Tensor, m: int, k: int) -> int:
    """Bytes the variant must move: each input it reads once (the offsets
    for a lookup, the distinct table rows for a fetch), each output once."""
    bsz = phys.shape[0]
    lookup = 0 if variant == "fetch_only" else bsz * 2 * m * 4
    table = 0 if variant in ("no_fetch", "lookup_only") else distinct_rows(phys, m) * CHUNK * 4
    meta = 9 if variant in ("full", "no_boundary", "no_fetch") else 4  # phys, p, is_eq | phys
    return lookup + table + bsz * k * (CHUNK * 4 + meta)


def measure(tab: torch.Tensor, off: torch.Tensor, k: int, card: str, tag: str = "[variants]") -> dict:
    """Each variant and its plain version timed (events, device and, for
    the kernel, cold-L2 device and its share of the bound), beside its
    bound; then the library calls that do a part of the work.  Prints one
    line each; returns {variant | 'library ...': {...}}."""
    bsz, m, _ = tab.shape
    shape = f"B={bsz} ({m},{CHUNK}) k={k}"
    res = {}
    for variant in VARIANTS:
        run = lambda v=variant: lookup_fetch_variant(tab, off, k, v)  # noqa: E731
        plain = lambda v=variant: lookup_fetch_variant_reference(tab, off, k, v)  # noqa: E731
        phys = run()[1]
        ms, pms = median_ms(run), median_ms(plain, 5)
        dev, pdev = device_profile(run, kernels_per_call=1)[0], device_profile(plain)[0]
        cold = cold_ms(run)
        bms, bby = bound(variant_bytes(variant, phys, m, k))
        share = bms / cold if cold else None  # the bound moves every byte at the memory rate
        res[variant] = dict(ms=ms, device_ms=dev, cold_ms=cold, plain_ms=pms, plain_device_ms=pdev,
                            bound_ms=bms, bound_by=bby, device_share_of_bound=share)
        print(f"{tag} {shape} {variant:>11}: kernel {ms:.4f} ms (device {fmt_ms(dev)}, cold "
              f"{fmt_ms(cold)}, {fmt_share(share)} of bound), plain {pms:.4f} ms (device "
              f"{fmt_ms(pdev)}), bound {bms:.4f} ms ({bby}) | {card}", flush=True)
    phys = lookup_fetch(tab, off, k)[1]
    s = torch.arange(k, dtype=torch.int32, device=tab.device).expand(bsz, k).contiguous()
    gidx = phys.long()[..., None].expand(-1, -1, CHUNK)
    for name, call in (("torch.searchsorted (the lookup alone)",
                        lambda: torch.searchsorted(off, s, right=True)),
                       ("torch.gather of the full variant's rows (the fetch alone)",
                        lambda: torch.gather(tab, 1, gidx))):
        ms, dev = median_ms(call), device_profile(call)[0]
        res[f"library {name}"] = dict(ms=ms, device_ms=dev)
        print(f"{tag} {shape} library {name}: {ms:.4f} ms (device {fmt_ms(dev)}) | {card}", flush=True)
    def split(a, b):
        da, db = res[a]["device_ms"], res[b]["device_ms"]
        return fmt_ms(None if da is None or db is None else da - db)

    print(f"{tag} {shape} device-time splits: boundary search (full - no_boundary) "
          f"{split('full', 'no_boundary')}, row read (full - no_fetch) {split('full', 'no_fetch')}, "
          f"p/is_eq writes (no_fetch - lookup_only) {split('no_fetch', 'lookup_only')}, search and "
          f"p/is_eq writes (full - fetch_only) {split('full', 'fetch_only')} | {card}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH, help="images (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0, help="input seed (default: %(default)s)")
    args = ap.parse_args(argv)
    device = require_cuda("lookup_kernel_variants")
    card = card_line()
    tab, off = make_inputs(args.batch, device, args.seed)
    check(tab, off, K, f"B={args.batch}")
    print(f"[variants] B={args.batch} ({NC},{CHUNK}) k={K}: all {len(VARIANTS)} variants bit-identical "
          f"to their plain versions, full to lookup_fetch | {card}", flush=True)
    measure(tab, off, K, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
