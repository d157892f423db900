"""Where the time of ``row_fetch`` and ``compact_place`` goes, on the card.

    python -m yolort_tpu_torch.experiments.fetch_place_variants [--seed 0]

Builds ``csrc/row_fetch.cu`` and ``csrc/compact_select.cu`` as they are
and with one part changed or taken out (``VARIANTS``), each by its own
``nvcc`` into ``build/yolort_tpu_torch/fetch_place_variants/``, and times
every build on the stage-2 tables of the serving (325, 128) k = 512 and
eval (2565, 128) k = 4096 configs: the profiler's device time with the L2
warm and with it flushed before each launch (cold).

  * ``row_fetch`` at batch 8, on the main path's indices (the ``phys``
    that ``select_topk_threshold``'s default route hands it) at
    ``row_fetch_geometry``'s launch: as it is; with no stores; with no row
    loads (zeros stored); with the index load alone; empty (the launch).
  * ``compact_place`` at batch 1, 8 and 32: as it is (its block's warps
    chosen from the grid); with the warps fixed at 1 (one warp walks a
    whole run of 32 chunks), 4, 8, 16 or 32; and, at batch 8, with no
    stores (the tail's included); with no row loads; with the metadata
    alone; empty.

A build that computes the function is first held against the plain
version, bit for bit, on outputs filled with NaN and -1 first; a build
with a part taken out ("no ...", "... alone", "empty") computes something
else and only times.  Each line carries the bound (each input byte read
once, each output byte written once, at the card's memory rate) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from yolort_tpu_torch.experiments.timing import (
    bound, card_line, cold_ms, device_profile, distinct_rows, fmt_ms, require_cuda, same_bits,
)
from yolort_tpu_torch.ops.cuda import (
    _build, bisect_count, compact_place_reference, lookup_fetch_reference, row_fetch_reference,
)
from yolort_tpu_torch.ops.cuda.lookup_kernel import row_fetch_geometry

TABLES = {"serving": (325, 512, 0.25), "eval": (2565, 4096, 0.005)}  # (chunks m, k, threshold)
BATCHES = (1, 8, 32)
_RULE = ("  int warps = 8;\n"
         "  while (warps < kMaxWarps && warps * 3 / 2 <= want) warps *= 2;\n")
# each variant: the source it edits and the edits that make it; the parts
# taken out keep their inputs live (a condition the compiler cannot fold)
VARIANTS = {
    "row_fetch": ("row_fetch.cu", ()),
    "row_fetch no stores": ("row_fetch.cu", (
        ("if (c0 + lane + 32 * w < units) d[32 * w] = cur[w];",
         "if (c0 + lane + 32 * w < units && m < 0) d[32 * w] = cur[w];"),)),
    "row_fetch no row loads": ("row_fetch.cu", (
        ("if (c0 + lane + 32 * w < units) v[r][w] = __ldg(src + 32 * w);",
         "if (c0 + lane + 32 * w < units) v[r][w] = T();"),)),
    "row_fetch index alone": ("row_fetch.cu", (
        ("for (int r0 = s0; r0 < n && r0 < s0 + 32; r0 += kRows) {",
         "if (own == -7) dst[lane] = T();\n"
         "    for (int r0 = s0; r0 < n && r0 < s0 + 32 && m < 0; r0 += kRows) {"),)),
    "row_fetch empty": ("row_fetch.cu", (
        ("if (first >= k) return;  // the whole warp", "if (first >= k || m > 0) return;"),)),
    "compact_place": ("compact_select.cu", ()),
    **{f"compact_place {n} warp{'s' if n > 1 else ''} a run": (
        "compact_select.cu", ((_RULE, f"  const int warps = {n};\n  (void)want;\n"),))
       for n in (1, 4, 8, 16, 32)},
    "compact_place no stores": ("compact_select.cu", (
        ("      if (pos < k) {", "      if (pos < k && m < 0) {"),
        ("s < k; s += step) {", "s < k && m < 0; s += step) {"))),
    "compact_place no row loads": ("compact_select.cu", (
        ("    tier::load_row(tab + (size_t)ch * 128, lane, v);",
         "    for (int j = 0; j < tier::kPasses; ++j) v[j] = tb + ((lane + j) & 1);"),)),
    "compact_place metadata alone": ("compact_select.cu", (
        ("  for (; todo; todo &= todo - 1) {  // warp-uniform",
         "  if (todo == 0x12345u) vb[0] = 1.0f;\n  for (; todo && m < 0; todo &= todo - 1) {"),)),
    "compact_place empty": ("compact_select.cu", (
        ("  const int part = threadIdx.x >> 5;", "  if (m > 0) return;\n  const int part = threadIdx.x >> 5;"),)),
}


def computes(name: str) -> bool:
    """Whether a variant still computes the kernel's function."""
    return not (" no " in name or name.endswith((" alone", " empty")))


def variant_sources(sources: dict) -> dict:
    """{variant: source} from {file name: the kernel's source}; raises if
    an edit no longer matches its source (exactly once)."""
    out = {}
    for name, (file, edits) in VARIANTS.items():
        text = sources[file]
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"fetch_place_variants: variant {name!r}: {old!r} is not in "
                                 f"{file} once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """{variant: the loaded library}, one nvcc per variant, all started
    together."""
    out_dir = _build.BUILD_DIR / "fetch_place_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"fetch_place_variants: nvcc failed for {name!r}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        entry = "yt_row_fetch_p" if name.startswith("row_fetch") else "yt_compact_place"
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def times(run, check) -> str:
    """A build's warm and cold device time, after ``check`` where given."""
    if check is not None:
        check()
    return f"{fmt_ms(device_profile(run)[0])} (cold {fmt_ms(cold_ms(run))})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="input seed (default: %(default)s)")
    args = ap.parse_args(argv)
    device = require_cuda("fetch_place_variants")
    card = card_line()
    libs = build(variant_sources({f: (_build.CSRC_DIR / f).read_text()
                                  for f in ("row_fetch.cu", "compact_select.cu")}))
    rng = np.random.default_rng(args.seed)
    for cfg, (m, k, thr) in TABLES.items():
        for bsz in BATCHES:
            a, c = rng.standard_normal((2, bsz, m * 128)) * 2.0 - 1.0
            s = (1 / (1 + np.exp(-a))) * (1 / (1 + np.exp(-c)))
            tab = torch.from_numpy(s.astype(np.float32).reshape(bsz, m, 128)).to(device)
            thr_bits = int(np.float32(thr).view(np.int32))
            t, cg, ce = bisect_count(tab, k, thr_bits)
            cnt = torch.cat([cg, ce], 1).contiguous()
            off = (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()
            stream = _build.stream_of(tab)
            if bsz == 8:  # row_fetch on the main path's indices
                phys = lookup_fetch_reference(tab, off, k)[1]
                want = row_fetch_reference(tab, phys)
                out = torch.empty_like(want)
                g = row_fetch_geometry(512, bsz, k)
                line = []
                for name, lib in libs.items():
                    if not name.startswith("row_fetch"):
                        continue
                    def run(lib=lib):
                        _build.check(lib.yt_row_fetch_p(
                            tab.data_ptr(), phys.data_ptr(), out.data_ptr(), bsz, m, k, 512, *g,
                            stream), "fetch_place_variants")

                    def check(run=run, name=name):
                        out.fill_(float("nan"))
                        run()
                        if not same_bits(out, want):
                            raise AssertionError(f"fetch_place_variants {name} B={bsz} ({m},128) "
                                                 f"k={k}: differs from the plain version")
                    line.append(f"{name} {times(run, check if computes(name) else None)}")
                nbytes = bsz * k * 4 + distinct_rows(phys, m) * 512 + bsz * k * 512
                print(f"[variants] B={bsz} {cfg} ({m},128) k={k} main-path indices, geometry {g}, "
                      f"bound {bound(nbytes)[0]:.5f} ms: {'; '.join(line)} | {card}", flush=True)
            want = compact_place_reference(tab, cnt, off, t, thr_bits, k)
            vals = torch.empty(bsz, k, device=device)
            idx = torch.empty(bsz, k, dtype=torch.int32, device=device)
            line = []
            for name, lib in libs.items():
                if not name.startswith("compact_place") or (bsz != 8 and not computes(name)):
                    continue
                def run(lib=lib):
                    _build.check(lib.yt_compact_place(
                        tab.data_ptr(), cnt.data_ptr(), off.data_ptr(), t.data_ptr(), thr_bits,
                        bsz, m, k, vals.data_ptr(), idx.data_ptr(), stream), "fetch_place_variants")

                def check(run=run, name=name):
                    vals.fill_(float("nan"))
                    idx.fill_(-1)
                    run()
                    if not (same_bits(vals, want[0]) and torch.equal(idx, want[1])):
                        raise AssertionError(f"fetch_place_variants {name} B={bsz} ({m},128) "
                                             f"k={k}: differs from the plain version")
                line.append(f"{name} {times(run, check if computes(name) else None)}")
            busy = int(((cnt > 0) & (off < k)).view(bsz, 2, m).any(1).sum())
            nbytes = busy * 512 + bsz * 2 * m * 8 + bsz * 4 + bsz * k * 8
            print(f"[variants] B={bsz} {cfg} ({m},128) k={k}, bound {bound(nbytes)[0]:.5f} ms: "
                  f"{'; '.join(line)} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
