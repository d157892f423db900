"""yolov5ts, the TAN variant (ultralytics v5.0 ``yolov5s-transformer.yaml``:
the r4.0 layout with a ``C3TR`` at flat layer 9), on the port's normal
path, on the CPU and JAX-free:

- ``YOLOv5.load_from_yolov5`` reads the ``C3TR`` from the checkpoint: for
  each fabricated family it builds one exactly for TAN, with the
  detections of an explicit ``use_tan``, and refuses a contradicting one;
- the port against the benchmark's plain PyTorch reference
  (``portbench/reference/r40tan.py``, whose attention is
  ``nn.MultiheadAttention``), seeded as the benchmark seeds it, at nano
  width on a 256x320 canvas, in float32 and bfloat16, with the
  configuration's q/k/v gain, which gives the attention a trained
  layer's spread, so that the float32 comparison sees a wrong softmax scale;
- the ``attention`` span and ``attention_tokens`` counter under the
  profiler, and outputs bit-identical with it on and off;
- the benchmark's least work of the block (``portbench/bounds/_attention.py``)
  against a hand count at the ``ts-tile-b16`` cell's shapes, and its
  ``attention_*`` readers on a hand-made trace.
"""

from __future__ import annotations

import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_fixture import make_checkpoint
from yolort_tpu_torch.models._checkpoint import load_from_ultralytics
from yolort_tpu_torch.models.yolov5 import YOLOv5
from yolort_tpu_torch.ops.blocks import C3TR, TransformerLayer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import judge, weights  # noqa: E402
from portbench.bounds import _attention  # noqa: E402
from portbench.layers import _attention as readers  # noqa: E402
from portbench.reference import models, pipeline, r40tan  # noqa: E402
from portbench.spec import Bounds  # noqa: E402
from portbench.trace import DeviceEvent, OpEvent, Trace  # noqa: E402

SERVE = dict(score_thresh=0.05, pre_nms_topk=512)
# family: (make_checkpoint keywords, load version, classes, canvas side and rounding)
FAMILIES = {
    "r4.0": (dict(seed=8, version="r4.0"), "r4.0", 6, (96, 32)),
    "tan": (dict(seed=2, version="tan"), "r4.0", 6, (96, 32)),
    "r6.0": (dict(seed=3), "r6.0", 7, (96, 32)),
    "p6": (dict(seed=4, p6=True), "r6.0", 5, (128, 64)),
}


def _frames(seed, shape=(2, 80, 110, 3)):
    return list(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    make_kw, version, nc, (side, div) = FAMILIES[request.param]
    path = str(tmp_path_factory.mktemp("ckpt") / f"{request.param}.pt")
    make_checkpoint(path, nc=nc, dm=0.33, wm=0.25, **make_kw)
    kw = dict(version=version, device="cpu", size=(side, side), size_divisible=div, **SERVE)
    return request.param, path, kw


def test_load_reads_the_c3tr_from_the_checkpoint(family):
    """Without ``use_tan`` the load builds a C3TR exactly for the TAN
    checkpoint, and serves the detections of the build with an explicit
    ``use_tan`` that agrees, bit for bit."""
    name, path, kw = family
    tan = name == "tan"
    assert load_from_ultralytics(path, version=kw["version"])["use_tan"] is tan
    m = YOLOv5.load_from_yolov5(path, **kw)
    assert any(isinstance(b, C3TR) for b in m.model.modules()) is tan
    explicit = YOLOv5.load_from_yolov5(path, use_tan=tan, **kw)
    imgs = _frames(5)
    got, want = m(imgs), explicit(imgs)
    assert sum(len(d["scores"]) for d in got) > 0
    for g, w in zip(got, want):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


def test_a_contradicting_use_tan_raises(family):
    name, path, kw = family
    with pytest.raises(ValueError, match=r"layer model\.9 is (not )?a C3TR"):
        YOLOv5.load_from_yolov5(path, use_tan=name != "tan", **kw)


# --- the port against a plain reference -----------------------------------------------------

SEED = 2 ** 33 + 23
CANVAS = (256, 320)  # an 8 x 10 P5 map: 80 tokens an image
CONFIG = json.loads((ROOT / "portbench/configs/yolov5ts-r40-bf16.json").read_text())
# the benchmark's configuration at nano width and 6 classes on the small canvas,
# with its q/k/v gain (the draw alone leaves the scaled scores at std 0.01,
# a softmax within 5% of uniform, under which a dropped 1/sqrt(32) moves the
# median logit by 6e-5, three times the float32 tolerance; the gain of 8
# gives a trained layer's spread, and the same fault moves it by ~1e-2)
CFG = dict(CONFIG, nc=6, width_multiple=0.25, size=list(CANVAS))
POST = {"score_thresh": 0.25, "nms_thresh": 0.45, "pre_nms_topk": 512, "detections_per_img": 300}
# head logits against the float32 reference: the port folds each BatchNorm
# into its conv and runs the attention as matmuls, the reference keeps them
# apart and runs nn.MultiheadAttention, so float32 reorders sums: 2e-5 on
# logits of magnitude up to ~10 is that rounding; bfloat16's 8-bit mantissa
# reads a few 1e-3 at the median and up to ~0.1 (about 2^-8 of the logits it
# rounds, grown through the network), so it is held to 1e-2 at the median
# and 0.5 at the largest
LOGITS_F32 = 2e-5
LOGITS_BF16 = (1e-2, 0.5)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """(reference network, checkpoint path, frames, canvases): the
    benchmark's reference (``portbench/reference/r40tan.py``) seeded as
    the benchmark seeds it (``portbench/weights.py``), written as an
    ultralytics checkpoint."""
    imgs = _frames(SEED, (2, *CANVAS, 3))
    plan = pipeline.plan(CANVAS, CANVAS, 32)
    x = torch.stack([pipeline.letterbox(torch.from_numpy(f), plan) for f in imgs])
    net = r40tan.build(CFG)
    assert all(layer.qkv_gain == 8.0 for layer in net.modules()
               if isinstance(layer, r40tan.FTransformerLayer))
    weights.make(net, SEED, x, [torch.from_numpy(f) for f in imgs], CFG,
                 head_logits=r40tan.head_logits)
    path = os.path.join(tmp_path_factory.mktemp("tan"), "w.pt")
    r40tan.save_checkpoint(net, path)
    return net, path, imgs, x


def _port(path, dtype):
    return YOLOv5.load_from_yolov5(path, version="r4.0", device="cpu", dtype=dtype, size=CANVAS,
                                   **POST)


def _logit_errors(m, net, x):
    with torch.no_grad():
        got = m.model.head_outputs(x.permute(0, 2, 3, 1).contiguous().to(m.dtype))
        want = models.head_logits(net, x)
    return torch.cat([(g.float() - w.permute(0, 2, 3, 1, 4).reshape(g.shape)).abs().flatten()
                      for g, w in zip(got, want)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_matches_the_plain_reference(seeded, dtype):
    """Head logits within the stated tolerance of the dtype, and the
    served detections judged against ``pipeline.run`` on the same frames;
    bfloat16 fails the float32 tolerance."""
    net, path, imgs, x = seeded
    m = _port(path, getattr(torch, dtype))
    assert any(isinstance(b, C3TR) for b in m.model.modules())
    err = _logit_errors(m, net, x)
    refs = pipeline.run(net, [torch.from_numpy(f) for f in imgs], CFG, POST,
                        head_logits=r40tan.head_logits)
    outs = m(imgs)
    got = judge.judge(outs, refs, POST, 0.02, "cpu").numbers()
    assert sum(len(o["scores"]) for o in outs) > 0 and got["lost_frames"] == 0, got
    if dtype == "float32":
        assert float(err.max()) < LOGITS_F32
        assert got["score_err"] < 1e-5 and got["miss_gap"] < 1e-5 and got["box_err"] < 1e-4, got
    else:
        assert float(err.median()) < LOGITS_BF16[0] and float(err.max()) < LOGITS_BF16[1]
        assert float(err.max()) > LOGITS_F32
        assert got["score_err_p50"] < 0.008 and got["box_err_p50"] < 0.017, got


def test_the_float32_tolerance_sees_a_dropped_softmax_scale(seeded):
    """The port with its 1/sqrt(head width) undone (the q rows of the
    input projection and their bias times sqrt(32), which is the same
    function) fails the float32 tolerance at most logits."""
    net, path, _, x = seeded
    m = _port(path, torch.float32)
    layer = next(b for b in m.model.modules() if isinstance(b, TransformerLayer))
    c = layer.in_proj_w.shape[1]
    with torch.no_grad():
        layer.in_proj_w[:c].mul_(math.sqrt(c // layer.num_heads))
        layer.in_proj_b[:c].mul_(math.sqrt(c // layer.num_heads))
    assert float(_logit_errors(m, net, x).median()) > LOGITS_F32


# --- the attention span and counter -------------------------------------------------------------

def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    events = [(e.name().split("::", 1)[1], e.start_ns(), e.start_ns() + e.duration_ns(),
               list(e.concrete_inputs()))
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("yolort_tpu::span.", "yolort_tpu::count."))]
    return out, events


def test_the_attention_span_and_its_tokens(seeded):
    """Per call one ``span.attention`` inside ``span.network``, one
    ``count.attention_tokens`` of B x (H/32) x (W/32) inside it, and the
    same detections as with the profiler off."""
    _, path, imgs, _ = seeded
    m = _port(path, torch.float32)
    off = m(imgs)
    on, events = _profiled(lambda: [m(imgs), m(imgs)])
    nets = [e for e in events if e[0] == "span.network"]
    atts = [e for e in events if e[0] == "span.attention"]
    counts = [e for e in events if e[0] == "count.attention_tokens"]
    assert len(nets) == len(atts) == len(counts) == 2
    for net, att, cnt in zip(nets, atts, counts):
        assert net[1] <= att[1] and att[2] <= net[2]
        assert att[1] <= cnt[1] <= att[2]
        assert cnt[3] == [len(imgs) * (CANVAS[0] // 32) * (CANVAS[1] // 32)]
    for out in on:
        for g, w in zip(out, off):
            for key in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(g[key], w[key])


# --- the benchmark's attention bound and readers ------------------------------------------------

def test_the_attention_bound_by_hand():
    """The ``ts-tile-b16`` cell's shapes: 16 images of 1,600 tokens of 256
    channels, one layer.  Six 256 x 256 products a token (position; q, k,
    v, out, fc2 . fc1) and QK^T and AV: 20.13 + 41.94 = 62.08 GFLOP; the
    map in and out in bfloat16 and the six matrices and the position bias
    once: 27.0 MB."""
    assert _attention.block_width(CONFIG) == 256 and _attention.layers(CONFIG) == 1
    nbytes, ops = _attention.work(16 * 1600, 1, 1600, 256, 1, 2)
    assert ops == 2 * 25600 * 256 * 256 * 6 + 4 * 25600 * 1600 * 256 == 62_075_699_200
    assert nbytes == (2 * 25600 * 256 + 6 * 256 * 256 + 256) * 2 == 27_001_344


def _run(with_span=True, with_count=True):
    """A traced window of one call: 1 device ms launched in ``span.attention``
    and 9 more in the rest of ``portbench.network``."""
    ops = [OpEvent("span.request", 0, 10_000_000, [], [], []),
           OpEvent("span.network", 100, 9_000_000, [], [], [])]
    if with_span:
        ops.append(OpEvent("span.attention", 200, 400, [], [], []))
    if with_count:
        ops.append(OpEvent("count.attention_tokens", 250, 251, [], [], [25600]))
    device = [DeviceEvent("attn", "kernel", 1_000, 1_001_000, 300),
              DeviceEvent("conv", "kernel", 2_000_000, 11_000_000, 500)]
    spans = [("portbench.request", 0, 10_000_000), ("portbench.network", 100, 9_000_000)]
    trace = Trace((0, 10_000_000), spans, device, sorted(ops, key=lambda o: o.start))
    return SimpleNamespace(trace=trace, batches=1, canvas=(1280, 1280), bounds=Bounds(),
                           cell=SimpleNamespace(config=CONFIG))


def test_the_attention_readers_on_a_hand_made_trace():
    run = _run()
    assert readers.attention_ms(run) == pytest.approx(1.0)
    assert readers.attention_share_pct(run) == pytest.approx(10.0)
    least = max(27_001_344 / 3.35e12, 62_075_699_200 / 9.89e14)
    assert readers.attention_roofline_pct(run) == pytest.approx(100.0 * least / 1e-3)
    assert 0 < readers.attention_roofline_pct(run) < 100


@pytest.mark.parametrize("missing", ["counter", "span", "trace"])
def test_the_attention_readers_read_none_without_their_events(missing):
    """Without the counter the roofline reads None; without the span (a
    program that records none) or a trace, every reader does."""
    run = _run(with_span=missing != "span", with_count=missing != "counter")
    if missing == "trace":
        run.trace = None
    assert readers.attention_roofline_pct(run) is None
    if missing != "counter":
        assert readers.attention_ms(run) is None and readers.attention_share_pct(run) is None
