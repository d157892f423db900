"""Where the qconv kernel's time goes, on the card.

    python -m yolort_tpu_torch.experiments.qconv_split [--batch 8] [--seed 0]

Builds ``csrc/qconv.cu`` as it is and with one part of the kernel taken
out (``VARIANTS``: the epilogue's arithmetic, the copy-out of the output
tile, the tensor-core products, the A and B slab loads), each by its own
``nvcc`` into ``build/yolort_tpu_torch/qconv_split/``, and times every
build on representative conv shapes of int8 yolov5s @640 (``SHAPES``) by
CUDA-graph replay: device time without host gaps.  The full build is
first held bit-identical to the plain version.  A variant computes wrong
values; it measures what the part it lacks costs, and is no kernel of
the port.  Each line carries the shape's bound (activations, weights,
scale and bias read once, the output written once, at the card's memory
rate; or the int8 operations at the tensor cores' rate, where larger)
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from yolort_tpu_torch.experiments.timing import bound, card_line, graph_ms, require_cuda
from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.cuda.qconv_kernel import (
    ACTS, _OUT_KINDS, pack_weight, qconv_kxk_reference, qconv_plan,
)

BATCH = 8
# (k, stride, pad, cin, cout, input side, act, out dtype)
SHAPES = (
    (1, 1, 0, 64, 64, 160, "silu", torch.int8),        # the widest 1x1
    (3, 1, 1, 64, 64, 80, "silu", torch.int8),         # a bottleneck 3x3
    (3, 1, 1, 128, 128, 40, "silu", torch.int8),       # near the balance point
    (1, 1, 0, 512, 256, 20, "silu", torch.int8),       # a 20x20 1x1
    (1, 1, 0, 128, 255, 80, "none", torch.float32),    # the P3 head conv
    (6, 2, 2, 3, 32, 640, "silu", torch.int8),         # the stem (gather loader)
)
# each variant: the edits of the source that take its part out
VARIANTS = {
    "full": (),
    "no epilogue math": (
        ("const float y0 = epilogue_value(acc[mi][ni][2 * h], sc0, bi0, e.act);",
         "const float y0 = __int_as_float(acc[mi][ni][2 * h]);"),
        ("const float y1 = epilogue_value(acc[mi][ni][2 * h + 1], sc1, bi1, e.act);",
         "const float y1 = __int_as_float(acc[mi][ni][2 * h + 1]);"),
        ("const uint16_t lo = (uint8_t)requantize(y0, e.inv_out_scale);",
         "const uint16_t lo = (uint8_t)__float_as_int(y0);"),
        ("const uint16_t hi = (uint8_t)requantize(y1, e.inv_out_scale);",
         "const uint16_t hi = (uint8_t)__float_as_int(y1);"),
    ),
    "no copy-out": (  # s.Cout < 0 never holds, which the compiler cannot know
        ("if ((s.Cout * osz) % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {",
         "if (s.Cout < 0) {"),
        ("for (int i = tid; i < BM * BN; i += T::kThreads) {",
         "for (int i = tid; i < BM * BN * (s.Cout < 0); i += T::kThreads) {"),
    ),
    "no products": (  # the fragments stay live, so the ldmatrix loads stay
        ("for (int ni = 0; ni < T::kNI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);",
         "for (int ni = 0; ni < T::kNI; ++ni) acc[mi][ni][0] ^= af[mi][0] ^ bf[ni][1];"),
    ),
    "no loads": (
        ("if (st < nk) load_slab(st);", "(void)st;"),
        ("if (ahead < nk) load_slab(ahead % kStages);", "(void)ahead;"),
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
                raise ValueError(f"qconv_split: variant {name!r}: {old!r} is not in qconv.cu once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """{variant: the loaded ``yt_qconv_kxk``}, one nvcc per variant, all
    started together."""
    out_dir = _build.BUILD_DIR / "qconv_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"qconv_split: nvcc failed for {name!r}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).yt_qconv_kxk
        fn.argtypes = _build._SIGNATURES["yt_qconv_kxk"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH, help="images (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0, help="input seed (default: %(default)s)")
    args = ap.parse_args(argv)
    device = require_cuda("qconv_split")
    card = card_line()
    fns = build(variant_sources((_build.CSRC_DIR / "qconv.cu").read_text()))
    rng = np.random.default_rng(args.seed)
    for k, s, pad, cin, cout, side, act, dt in SHAPES:
        n, ho = args.batch, (side + 2 * pad - k) // s + 1
        xq = torch.from_numpy(rng.integers(-127, 128, (n, side, side, cin), dtype=np.int8))
        xq = xq.to(device).permute(0, 3, 1, 2)  # NHWC bytes seen as channels_last NCHW
        wq = pack_weight(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(device)
        scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, cout).astype(np.float32)).to(device)
        bias = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32)).to(device)
        ios = 6.0 if dt == torch.int8 else None
        out = torch.empty((n, cout, ho, ho), dtype=dt, device=device,
                          memory_format=torch.channels_last)
        plan = qconv_plan(n * ho * ho, cout, k * k * cin, cin, wq.shape[1])

        def call(fn):  # on the current stream, which a graph capture replaces
            return fn(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                      float(ios or 0.0), out.data_ptr(), n, side, side, cin, cout, k, s, pad, ho,
                      ho, ACTS[act], _OUT_KINDS[dt], plan.tile, int(plan.gather), plan.smem,
                      _build.stream_of(xq))

        with torch.inference_mode():
            _build.check(call(fns["full"]), "qconv_split")
            want = qconv_kxk_reference(xq, wq, scale, bias, k=k, stride=s, pad=pad, act=act,
                                       inv_out_scale=ios, out_dtype=dt)
            if not torch.equal(out, want):
                raise AssertionError(f"qconv_split: the full build differs from the plain version "
                                     f"at {k}x{k}/s{s} {cin}->{cout} @{side}")
            times = {name: graph_ms(lambda fn=fn: call(fn)) for name, fn in fns.items()}
        nbytes = xq.numel() + wq.numel() + 8 * cout + out.numel() * out.element_size()
        bms, by = bound(nbytes, 2.0 * out.numel() * k * k * cin, "int8")
        split = ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
        print(f"[split] B={n} {k}x{k}/s{s} {cin}->{cout} @{side} {act} -> {str(dt)[6:]}, tile "
              f"{plan.bm}x{plan.bn} {'gather' if plan.gather else 'cp.async'}: bound {bms:.4f} ms "
              f"({by}); device ms (graph replay): {split} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
