"""What the fused_cells_stage1 kernel's ring and reduction cost, on the card.

    python -m yolort_tpu_torch.experiments.stage1_variants [--seed 0]

Builds ``csrc/cells_stage1.cu`` as it is and with one choice changed
(``VARIANTS``: the reduction's max instruction, the tile's size, the depth
of the ring and so the blocks an SM, or the maxima taken out), each by its own
``nvcc`` into ``build/yolort_tpu_torch/stage1_variants/``, and times every
build on the yolov5s head levels @640 at batch 8 and 32 in float32 and
bfloat16 by CUDA-graph replay: device time without host gaps.  Every
build but "no maxima" is first held against the plain version, bit for
bit (NaN positions compared as NaN).  "no maxima" writes no maxima; it
measures what the reduction costs beside the copy, and is no kernel of
the port.  Each line carries each build's plan, the bound (the levels
read once, the table and the maxima written once, at the card's memory
rate), ``torch.cat`` of the levels alone, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from yolort_tpu_torch.experiments.timing import (
    bound, card_line, graph_ms, require_cuda, same_bits,
)
from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.cuda.stage1_kernel import NEG_LOGIT, fused_cells_stage1_reference

SIZES = ((80, 80), (40, 40), (20, 20))  # yolov5s head levels @640
BATCHES = (8, 32)
# each variant: the edits of the source that make it
VARIANTS = {
    "full": (),
    "max.NaN": (  # one instruction a value, which returns the canonical NaN
        ("{ return (x > m || x != x) ? x : m; }",
         '{\n  float r;\n  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(x));\n  return r;\n}'),
    ),
    "32 KB tiles": (("constexpr int kTileBytes = 16 * 1024;", "constexpr int kTileBytes = 32 * 1024;"),),
    "32 KB tiles, 3 stages": (
        ("constexpr int kTileBytes = 16 * 1024;", "constexpr int kTileBytes = 32 * 1024;"),
        ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;"),
    ),
    "8 KB tiles": (("constexpr int kTileBytes = 16 * 1024;", "constexpr int kTileBytes = 8 * 1024;"),),
    "6 stages": (("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;"),),
    "stores evict_first": ((
        "__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {\n",
        "__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {\n"
        "  uint64_t pol;\n"
        '  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));\n'
        '  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, '
        '%3;" ::"l"(dst), "r"(shared_addr(src)), "r"(bytes), "l"(pol) : "memory");\n'
        '  asm volatile("cp.async.bulk.commit_group;" ::: "memory");\n'
        "  return;\n"),),
    "loads evict_first": ((
        "__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {\n",
        "__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {\n"
        "  uint64_t pol;\n"
        '  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));\n'
        '  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint '
        '[%0], [%1], %2, [%3], %4;" ::"r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar)), '
        '"l"(pol) : "memory");\n'
        "  return;\n"),),
    "no maxima": (  # nseg * (C < 0) is 0, which the compiler cannot know
        ("for (int q0 = 0; q0 < nseg; q0 += kGroups) {",
         "for (int q0 = 0; q0 < nseg * (C < 0); q0 += kGroups) {"),
    ),
}


def variant_sources(source: str) -> dict:
    """{variant: source} from the kernel's source; raises if an edit no
    longer matches it (exactly once)."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"stage1_variants: variant {name!r}: {old!r} is not in "
                                 f"cells_stage1.cu once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """{variant: the loaded library}, one nvcc per variant, all started
    together."""
    out_dir = _build.BUILD_DIR / "stage1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"stage1_variants: nvcc failed for {name!r}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for entry in ("yt_cells_stage1", "yt_cells_stage1_plan"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def plan_of(lib, dtype) -> tuple:
    """(rows, stages, stage bytes, shared memory, grid) of a build."""
    out = (ctypes.c_int * 5)()
    _build.check(lib.yt_cells_stage1_plan(255, torch.finfo(dtype).bits // 8,
                                          ctypes.addressof(out)), "stage1_variants plan")
    return tuple(out)


def launch(lib, levels, outs) -> None:
    """One launch of a build on the current stream, as the wrapper makes it."""
    rows = [lv.shape[1] * lv.shape[2] for lv in levels]
    neg = float(torch.tensor(NEG_LOGIT, dtype=levels[0].dtype))
    _build.check(lib.yt_cells_stage1(
        *[lv.data_ptr() for lv in levels], None, *rows, 0, len(levels), levels[0].shape[0], 255,
        3, 85, neg, levels[0].element_size(), *[o.data_ptr() for o in outs],
        _build.stream_of(levels[0])), "stage1_variants")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="input seed (default: %(default)s)")
    args = ap.parse_args(argv)
    device = require_cuda("stage1_variants")
    card = card_line()
    libs = build(variant_sources((_build.CSRC_DIR / "cells_stage1.cu").read_text()))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for dtype in (torch.float32, torch.bfloat16):
        plans = "; ".join(f"{name} {plan_of(lib, dtype)}" for name, lib in libs.items())
        print(f"[variants] {dtype} plans (rows, stages, stage bytes, shared memory, grid): "
              f"{plans}", flush=True)
        for bsz in BATCHES:
            levels = [torch.randn((bsz, h, w, 255), generator=gen, device=device).mul_(3).to(dtype)
                      for h, w in SIZES]
            ref = fused_cells_stage1_reference(levels, 3, 85)
            outs = [torch.empty_like(r) for r in ref]
            times = {}
            for name, lib in libs.items():
                launch(lib, levels, outs)
                torch.cuda.synchronize()
                if name != "no maxima" and not all(same_bits(a, b) for a, b in zip(outs, ref)):
                    raise AssertionError(f"stage1_variants: {name!r} differs from the plain "
                                         f"version at B={bsz} {dtype}")
                times[name] = graph_ms(lambda lib=lib: launch(lib, levels, outs))
            flat = [lv.reshape(bsz, -1, 255) for lv in levels]
            cat = graph_ms(lambda: torch.cat(flat, dim=1))
            n_cells = sum(h * w for h, w in SIZES)
            esize = levels[0].element_size()
            bms, by = bound(2 * bsz * n_cells * 255 * esize + 2 * bsz * n_cells * 3 * esize)
            split = ", ".join(f"{name} {ms:.4f} ({100 * bms / ms:.1f}%)" for name, ms in times.items())
            print(f"[variants] B={bsz} {dtype} 80x80+40x40+20x20: bound {bms:.4f} ms ({by}); "
                  f"device ms (graph replay, share of bound): {split}; torch.cat alone {cat:.4f} "
                  f"| {card}", flush=True)
            del levels, ref, outs, flat
    return 0


if __name__ == "__main__":
    sys.exit(main())
