"""``row_fetch`` and ``compact_place`` timed at the main path's shapes, in
this tree or against another checkout of the port, on the card.

    python -m yolort_tpu_torch.experiments.fetch_place_compare [--against DIR] [--batch 8]

Without ``--against`` it times this tree's kernels once and prints one JSON
line.  With ``--against DIR`` (the root of another checkout, e.g. a parent
commit unpacked by ``git archive`` into a git-ignored directory) it runs
itself in four processes, in the order DIR, this tree, this tree, DIR, each
with ``PYTHONPATH`` set to its tree, so that each builds and times its own
kernels on the same card in one call; then it prints every figure of the
four runs side by side.  It uses only what both trees have: the wrappers,
``fetch_block_sweep``'s inputs and ``timing``'s helpers.

Each run, at batch ``--batch`` (default 8):

  * ``row_fetch`` on the stage-2 tables of the serving (325, 128) k = 512
    and eval (2565, 128) k = 4096 configs, with random indices in
    [-5, m + 5) and with the main path's own: the ``phys`` that
    ``select_topk_threshold``'s default route hands it (bisect_count's tier
    offsets, the chunk of each slot), on sigmoid-product score tables;
  * ``row_fetch`` on the cells table (8400, 255) bf16 at k = 4104 in two
    sorted runs (``fetch_block_sweep``'s), at its own geometry;
  * ``compact_place`` (the whole call: the parent's zero fills too) on the
    same score tables and at batch 1 serving, with its device kernels a
    call counted from the profiler's rows;
  * at batch 128, the sweep's stage-2 table: ``row_fetch`` at its own
    geometry and ``row_fetch_p`` at every geometry of ``GEOMETRIES``.

Times: CUDA events over back-to-back calls, the profiler's device time
with the L2 warm, and with it flushed before each call (cold); beside the
bound (each input byte read once, each output byte written once, at the
card's memory rate) and the library call (``torch.gather`` of the rows;
``torch.nonzero`` of the gt-tier mask, the nearest partial call of
``compact_place``).  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
STAGE2 = {"serving": (325, 512, 0.25), "eval": (2565, 4096, 0.005)}  # (chunks m, k, threshold)


def score_table(seed: int, bsz: int, m: int, device) -> torch.Tensor:
    """(B, m, 128) sigmoid-product scores, as chip_smoke's score_table."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((bsz, m * 128)) * 2.0 - 1.0
    c = rng.standard_normal((bsz, m * 128)) * 2.0 - 1.0
    s = (1 / (1 + np.exp(-a))) * (1 / (1 + np.exp(-c)))
    return torch.from_numpy(s.astype(np.float32).reshape(bsz, m, 128)).to(device)


def tiers(table: torch.Tensor, k: int, thr: float):
    """(t, cnt, off, thr_bits): the k-th value bits and the (B, 2m) tier
    counts and exclusive offsets, from the tree's ``bisect_count``."""
    from yolort_tpu_torch.ops.cuda import bisect_count

    thr_bits = int(np.float32(thr).view(np.int32))
    t, cg, ce = bisect_count(table, k, thr_bits)
    cnt = torch.cat([cg, ce], 1).contiguous()
    off = (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()
    return t, cnt, off, thr_bits


def main_path_phys(off: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """The row of each of k slots, as ``select_topk_threshold``'s default
    route computes it from the tier offsets."""
    bsz = off.shape[0]
    s = torch.arange(k, device=off.device).expand(bsz, k).contiguous()
    c_of_s = (torch.searchsorted(off.long(), s, right=True) - 1).clamp(0, 2 * m - 1)
    return (c_of_s % m).to(torch.int32).contiguous()


def timed(fn, kernels_per_call=None) -> dict:
    """Events, warm device and cold device ms of ``fn``, and the device
    kernels a call that the profiler saw."""
    from yolort_tpu_torch.experiments.timing import cold_ms, device_profile, median_ms

    dev, rows = device_profile(fn, kernels_per_call=kernels_per_call)
    return dict(ms=median_ms(fn), device_ms=dev, cold_ms=cold_ms(fn), kernels=len(rows))


def worker(bsz: int) -> dict:
    """Every figure of one run of this process's tree (module docstring)."""
    import yolort_tpu_torch
    from yolort_tpu_torch.experiments import fetch_block_sweep as sweep
    from yolort_tpu_torch.experiments.timing import bound, card_line, distinct_rows
    from yolort_tpu_torch.ops.cuda import (
        compact_place, compact_place_reference, row_fetch, row_fetch_p, row_fetch_reference,
    )

    device = torch.device("cuda", 0)
    card = card_line()
    out = {"tree": str(Path(yolort_tpu_torch.__file__).resolve().parents[1]), "card": card}
    rng = np.random.default_rng(0)

    def fetch(label, tab, idx, lib=True):
        m, w = tab.shape[1], tab.shape[2]
        iv = torch.int32 if tab.dtype == torch.float32 else torch.int16
        if not torch.equal(row_fetch(tab, idx).view(iv), row_fetch_reference(tab, idx).view(iv)):
            raise AssertionError(f"row_fetch {label}: differs from the plain version")
        rb = w * tab.element_size()
        r = timed(lambda: row_fetch(tab, idx), kernels_per_call=1)
        r["bound_ms"] = bound(idx.numel() * 4 + distinct_rows(idx, m) * rb + idx.numel() * rb)[0]
        if lib:
            gidx = idx.long().clamp(0, m - 1)[..., None].expand(-1, -1, w)
            r["library"] = timed(lambda: torch.gather(tab, 1, gidx))
        out[f"row_fetch {label}"] = r
        print(f"[compare] row_fetch {label}: {json.dumps(r)} | {card}", flush=True)

    for cfg, (m, k, thr) in STAGE2.items():
        tab = score_table(40 + m, bsz, m, device)
        t, cnt, off, thr_bits = tiers(tab, k, thr)
        idx = torch.from_numpy(rng.integers(-5, m + 5, (bsz, k)).astype(np.int32)).to(device)
        fetch(f"B={bsz} ({m},128) k={k} random", tab, idx)
        fetch(f"B={bsz} ({m},128) k={k} main-path", tab, main_path_phys(off, k, m))
        for b, (ctab, ccnt, coff, ct) in ((bsz, (tab, cnt, off, t)),
                                          (1, (tab[:1].contiguous(), None, None, None))):
            if b == 1:
                if cfg != "serving":
                    continue
                ct, ccnt, coff, _ = tiers(ctab, k, thr)
            want = compact_place_reference(ctab, ccnt, coff, ct, thr_bits, k)
            got = compact_place(ctab, ccnt, coff, ct, thr_bits, k)
            if not all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got, want)):
                raise AssertionError(f"compact_place B={b} ({m},128) k={k}: differs from the plain version")
            r = timed(lambda: compact_place(ctab, ccnt, coff, ct, thr_bits, k))
            busy = int(((ccnt > 0) & (coff < k)).view(b, 2, m).any(1).sum())
            r["bound_ms"] = bound(busy * 512 + b * 2 * m * 8 + b * 4 + b * k * 8)[0]
            mask = ctab.view(torch.int32) >= ct[:, None, None] + 1
            r["library"] = timed(lambda: torch.nonzero(mask))
            out[f"compact_place B={b} ({m},128) k={k}"] = r
            print(f"[compare] compact_place B={b} ({m},128) k={k}: {json.dumps(r)} | {card}", flush=True)
        del tab, t, cnt, off

    inputs = sweep.make_inputs(bsz, device, seed=50)
    fetch(f"B={bsz} {sweep.LABELS['cells']}", *inputs["cells"])
    del inputs
    torch.cuda.empty_cache()
    tab, idx = sweep.make_inputs(128, device, seed=0)["stage2"]
    fetch(f"B=128 {sweep.LABELS['stage2']}", tab, idx, lib=False)
    r = sweep.measure(tab, idx, card, geometries=sweep.GEOMETRIES, label=sweep.LABELS["stage2"],
                      tag="[compare] row_fetch_p")
    out["row_fetch_p B=128 stage2"] = {str(g): r[g] for g in sweep.GEOMETRIES}
    if not row_fetch_p.launches:
        raise AssertionError("row_fetch_p never launched")
    return out


def compare(against: Path, bsz: int) -> int:
    """Run ``worker`` in four processes: ``against``, this tree, this tree,
    ``against``; print each figure of the four runs side by side."""
    runs = []
    for n, root in enumerate((against, ROOT, ROOT, against), 1):
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                              "--batch", str(bsz)], env=env, cwd=str(root), capture_output=True,
                             text=True, check=False)
        sys.stderr.write(res.stderr[-4000:])
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode != 0 or not lines:
            print(res.stdout[-4000:])
            raise RuntimeError(f"run {n} in {root} failed (rc {res.returncode})")
        runs.append(json.loads(lines[-1]))
        print(f"[compare] run {n}: {runs[-1]['tree']} | {runs[-1]['card']}", flush=True)
    names = ("parent 1", "change 2", "change 3", "parent 4")
    for key in runs[0]:
        if key in ("tree", "card") or key.startswith("row_fetch_p"):
            continue
        for metric in ("ms", "device_ms", "cold_ms", "kernels"):
            vals = [r[key][metric] for r in runs]
            print(f"[compare] {key} {metric}: " + ", ".join(f"{n} {v}" for n, v in zip(names, vals)))
        print(f"[compare] {key} bound_ms {runs[1][key]['bound_ms']}; library "
              f"{[r[key].get('library', {}).get('device_ms') for r in runs]} (device)")
    key = "row_fetch_p B=128 stage2"
    for n, r in zip(names, runs):
        best = min(r[key], key=lambda g: r[key][g]["device_ms"] or float("inf"))
        print(f"[compare] {key} {n}: best {best} device {r[key][best]['device_ms']} cold "
              f"{r[key][best]['cold_ms']}")
    print(json.dumps({"compare": dict(zip(names, runs))}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="root of another checkout to compare with")
    ap.add_argument("--batch", type=int, default=8, help="images (default: %(default)s)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from yolort_tpu_torch.experiments.timing import require_cuda

    require_cuda("fetch_place_compare")
    if args.against is not None:
        return compare(args.against.resolve(), args.batch)
    print(json.dumps(worker(args.batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
