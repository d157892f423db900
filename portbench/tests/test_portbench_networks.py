"""A configuration's reference network as a file of its own
(``Benchmark.reference``): the accepted r6.0 layouts read what they read
before it; a network with Linear and attention layers is seeded from the
seed, FLOP-counted and pickled under its ultralytics names."""

from __future__ import annotations

import hashlib
import json
import sys

import pytest
import torch
from torch import nn

from portbench import frames, weights
from portbench.reference import models, pipeline
from portbench.reference.arith import forward_flops
from portbench.spec import Benchmark, SpecError

from conftest import REPO

SEED = 2 ** 33 + 3
# each accepted configuration at a small canvas: its real widths, depth, classes and anchors
CANVAS = {"yolov5s-r60-f32": [64, 64], "yolov5s6-r60-bf16": [128, 128]}
# from the parent commit of the change that made the reference network a
# file of its own (027846f: ``models.build`` and ``weights.make``): the
# made state dict's digest, the calibration shift, the forward FLOPs at the
# canvas, and the digest of the checkpoint as the port's unpickler reads it.
# The BatchNorm statistics and the calibration pass through float32
# convolutions, whose rounding another torch build or CPU kernel may move:
# the digests and the shift hold on ``PINNED_ON`` (``torch.__version__``,
# ``torch.backends.cpu.get_cpu_capability()``) alone; the FLOPs everywhere.
PINNED_ON = ("2.13.0+cpu", "AVX512")
PINNED = {
    "yolov5s-r60-f32": ("9ecf5c8f8e79b51388604dd4371c1fd48c15c52fbb777c42096c3eae78b44ecf",
                        0.5000000186264515, 164335616,
                        "0bee70dfc83386939b037cb135289c402718a1df90527837ca542d0acc04fc93"),
    "yolov5s6-r60-bf16": ("a9ee9493d426c6ca8b170f635d657c7e4455ac279d7e487d3ba565e394f020e7",
                          0.5000000186264515, 671891456,
                          "28dc662b6994464039223549266cde11b8a98e122195e8f3c1b057055240dd44"),
}


def _config(name: str) -> dict:
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = next(c for c in doc["configs"] if c["name"] == name)
    return dict(json.loads((REPO / conf["file"]).read_text()), size=CANVAS[name])


def _made(net: nn.Module, cfg: dict, head_logits=models.head_logits):
    """``weights.make`` on the configuration's canvas, from ``SEED``: the
    shift and the canvas."""
    side = cfg["size"]
    pool = frames.make_pool({"batch": 2, "pool": 2, "sizes": [[side[0] * 3 // 4, side[1]]]}, SEED, "cpu")
    flat = [torch.from_numpy(f) for req in pool for f in req]
    plans = [pipeline.plan(tuple(f.shape[:2]), tuple(side), cfg["size_divisible"]) for f in flat]
    x = torch.stack([pipeline.letterbox(f, p) for f, p in zip(flat, plans)])
    shift = weights.make(net, SEED, x, flat, cfg, head_logits=head_logits)
    return shift, plans[0].canvas


def _digest(named, strings=()) -> str:
    h = hashlib.sha256()
    for text in strings:
        h.update(text.encode())
    for k, v in named:
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _read_back(path: str):
    """The checkpoint as the port's stub unpickler reads it: (dotted
    name, class path) of every module and (dotted name, tensor) of every
    parameter and buffer."""
    from yolort_tpu_torch.models._checkpoint import load_torch_checkpoint

    classes, tensors = [], []

    def walk(m, prefix):
        d = object.__getattribute__(m, "__dict__")
        cls = type(m)
        classes.append((prefix, f"{cls.__module__}.{cls.__name__}"))
        for key in ("_parameters", "_buffers"):
            tensors.extend((prefix + k, v) for k, v in (d.get(key) or {}).items() if v is not None)
        for k, sub in (d.get("_modules") or {}).items():
            if sub is not None:
                walk(sub, prefix + k + ".")

    walk(load_torch_checkpoint(path)["model"], "")
    return classes, tensors


def _yardstick(name: str, tmp_path) -> tuple:
    """The configuration built through ``Benchmark.reference`` and through
    ``models.build`` directly, asserted the same network, made weights,
    calibration, FLOPs and checkpoint; returns what ``PINNED`` holds."""
    cfg = _config(name)
    assert "reference" not in cfg
    ref = Benchmark(REPO).reference(cfg)
    assert ref.__file__.endswith("reference/r60.py")
    torch.manual_seed(0)  # the construction-time values, which weights.make replaces
    a = ref.build(cfg)
    torch.manual_seed(0)
    b = models.build(cfg["p6"], cfg["nc"], cfg["depth_multiple"], cfg["width_multiple"], cfg["anchors"])
    assert type(a) is type(b) and not a.training
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)

    shift_a, canvas = _made(a, cfg, ref.head_logits)
    shift_b, _ = _made(b, cfg)
    sa, sb = a.state_dict(), b.state_dict()
    assert shift_a == shift_b and all(torch.equal(sa[k], sb[k]) for k in sa)

    x = torch.zeros((1, 3, *canvas))
    fa = forward_flops(lambda z: ref.head_logits(a, z), x)
    assert fa == forward_flops(lambda z: models.head_logits(b, z), x)

    ref.save_checkpoint(a, str(tmp_path / "a.pt"))
    models.save_checkpoint(b, str(tmp_path / "b.pt"))
    (ca, ta), (cb, tb) = _read_back(str(tmp_path / "a.pt")), _read_back(str(tmp_path / "b.pt"))
    assert ca == cb and [k for k, _ in ta] == [k for k, _ in tb]
    assert all(torch.equal(u, v) for (_, u), (_, v) in zip(ta, tb))
    half = {k: (v.half() if v.is_floating_point() else v) for k, v in sa.items()}
    assert dict(ta).keys() == half.keys() and all(torch.equal(v, half[k]) for k, v in ta)
    assert {c for _, c in ca} >= {"models.yolo.Model" if cfg["p6"] else "models.yolo.DetectionModel",
                                  "models.common.C3", "models.common.SPPF", "models.yolo.Detect"}
    return _digest(sa.items()), shift_a, fa, _digest(ta, [" ".join(c) for c in ca])


@pytest.fixture(scope="module")
def yardstick(tmp_path_factory):
    """``_yardstick`` of a configuration, made once for this module."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _yardstick(name, tmp_path_factory.mktemp(name))
        return made[name]
    return get


@pytest.mark.parametrize("name", list(CANVAS))
def test_the_yardstick_has_not_moved(yardstick, name):
    """Each accepted configuration built through ``Benchmark.reference``
    and through ``models.build`` directly: the same network, the same made
    weights and calibration, the same FLOPs and checkpoint, and the
    parent's FLOPs."""
    assert yardstick(name)[2] == PINNED[name][2]


@pytest.mark.parametrize("name", list(CANVAS))
def test_the_made_weights_are_the_parents(yardstick, name):
    """The made weights, the shift and the checkpoint read back, each the
    parent's digest, on the torch build and CPU kernels they were taken on."""
    here = (torch.__version__, torch.backends.cpu.get_cpu_capability())
    if here != PINNED_ON:
        pytest.skip(f"digests pinned on torch {PINNED_ON[0]}, {PINNED_ON[1]}; here {here}")
    digest, shift, _, read_back = yardstick(name)
    assert (digest, shift, read_back) == tuple(PINNED[name][i] for i in (0, 1, 3))


# --- a network with Linear and attention layers ---------------------------
# ultralytics v5.0 models/common.py TransformerLayer, TransformerBlock and
# C3TR, as the port's test oracle writes them (tests/torch_fixture.py)

class FTransformerLayer(nn.Module):
    def __init__(self, c, num_heads):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(embed_dim=c, num_heads=num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma(self.q(x), self.k(x), self.v(x))[0] + x
        x = self.fc2(self.fc1(x)) + x
        return x


class FTransformerBlock(nn.Module):
    def __init__(self, c1, c2, num_heads, num_layers):
        super().__init__()
        self.conv = None
        if c1 != c2:
            self.conv = models.FConv(c1, c2)
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*[FTransformerLayer(c2, num_heads) for _ in range(num_layers)])
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, _, w, h = x.shape
        p = x.flatten(2).unsqueeze(0).transpose(0, 3).squeeze(3)
        return self.tr(p + self.linear(p)).unsqueeze(3).transpose(0, 3).reshape(b, self.c2, w, h)


class FC3TR(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = models.FConv(c1, c_, 1, 1)
        self.cv2 = models.FConv(c1, c_, 1, 1)
        self.cv3 = models.FConv(2 * c_, c2, 1)
        self.m = FTransformerBlock(c_, c_, 4, n)

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class TinyTR(nn.Module):
    """Three stride-2 convs, a C3TR over the stride-8 map's pixels, one
    Detect level."""

    def __init__(self, nc=4, c=32):
        super().__init__()
        self.model = nn.Sequential(models.FConv(3, c, 3, 2), models.FConv(c, c, 3, 2),
                                   models.FConv(c, c, 3, 2), FC3TR(c, c, n=1),
                                   models.FDetect(nc, [[10, 13, 16, 30, 33, 23]], (c,)))
        self.model[-1].stride = torch.tensor([8.0])
        with torch.no_grad():
            self.model[-1].anchors /= 8.0

    def forward(self, x):
        m = self.model
        return m[4]([m[3](m[2](m[1](m[0](x))))])


TINY_CFG = {"size": [64, 64], "size_divisible": 32,
            "assumed": {"class_bias_noise": 1.0, "candidates_above_0.25": 8}}
EXTRA = {FC3TR: ("models.common", "C3TR"), FTransformerBlock: ("models.common", "TransformerBlock"),
         FTransformerLayer: ("models.common", "TransformerLayer"), TinyTR: ("models.yolo", "Model")}


def _tiny() -> TinyTR:
    torch.manual_seed(0)  # the same construction-time values in every net
    return TinyTR().eval()


def test_linear_and_attention_leaves_are_seeded():
    built = {k: v.clone() for k, v in _tiny().named_parameters()}
    a, b, c = _tiny(), _tiny(), _tiny()
    _made(a, TINY_CFG)
    _made(b, TINY_CFG)
    pool = frames.make_pool({"batch": 2, "pool": 2, "sizes": [[48, 64]]}, SEED + 1, "cpu")
    flat = [torch.from_numpy(f) for req in pool for f in req]
    x = torch.stack([pipeline.letterbox(f, pipeline.plan((48, 64), (64, 64), 32)) for f in flat])
    weights.make(c, SEED + 1, x, flat, TINY_CFG)
    pa, pb, pc = (dict(n.named_parameters()) for n in (a, b, c))
    dense = [k for k in pa if ".tr." in k or k.endswith("m.linear.weight") or k.endswith("m.linear.bias")]
    assert any(k.endswith("ma.in_proj_weight") for k in dense)
    assert any(k.endswith("ma.out_proj.bias") for k in dense)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k                 # the seed decides every leaf
        assert not torch.equal(pa[k], built[k]), k          # none keeps its construction-time value
    for k in dense:
        assert not torch.equal(pa[k], pc[k]), k             # another seed draws others
        fan = pa[k].shape[-1] if pa[k].dim() == 2 else 16   # the block's width
        assert float(pa[k].detach().abs().max()) <= fan ** -0.5 * (1 + 1e-3), k


def test_a_leaf_no_draw_reaches_is_an_error():
    net = _tiny()
    net.model[3].norm = nn.LayerNorm(32)
    with pytest.raises(ValueError, match="norm"):
        _made(net, TINY_CFG)


def test_attention_flops_are_counted():
    """``forward_flops`` of the C3TR block against a count by hand: its
    1x1 convs, the position Linear, and in each layer the q/k/v Linears,
    the attention's three input projections, QK^T, AV, its output
    projection and the two Linears of the feed-forward."""
    bsz, c1, h, w = 2, 32, 8, 6
    block = _tiny().model[3]
    c_, L = 16, h * w
    convs = 2 * bsz * h * w * (c1 * c_ + c1 * c_ + 2 * c_ * c1)
    linears = 2 * bsz * L * c_ * c_ * (1 + 9)
    attention = 2 * (2 * bsz * L * L * c_)  # QK^T and AV, over all heads
    assert forward_flops(block, torch.zeros(bsz, c1, h, w)) == convs + linears + attention


def test_a_checkpoint_with_extra_classes(tmp_path):
    """``save_checkpoint(..., extra=...)`` pickles the block's classes
    under their ultralytics names, for that call only; the port's stub
    unpickler reads them back to the same tensors."""
    net = _tiny()
    _made(net, TINY_CFG)
    path = str(tmp_path / "tr.pt")
    models.save_checkpoint(net, path, extra=EXTRA)
    assert "models" not in sys.modules and "models.common" not in sys.modules
    assert FC3TR.__module__ == __name__ and FC3TR.__name__ == "FC3TR"
    assert models.FConv.__module__ == models.__name__ and models.FConv.__name__ == "FConv"
    classes, tensors = _read_back(path)
    paths = dict(classes)
    assert paths[""] == "models.yolo.Model" and paths["model.3."] == "models.common.C3TR"
    assert paths["model.3.m."] == "models.common.TransformerBlock"
    assert paths["model.3.m.tr.0."] == "models.common.TransformerLayer"
    assert paths["model.3.m.tr.0.ma."] == "torch.nn.modules.activation.MultiheadAttention"
    assert paths["model.0."] == "models.common.Conv" and paths["model.4."] == "models.yolo.Detect"
    want = {k: (v.half() if v.is_floating_point() else v) for k, v in net.state_dict().items()}
    got = dict(tensors)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    # ``extra`` held for that call alone: the next one pickles the block under its own name
    models.save_checkpoint(net, str(tmp_path / "own.pt"))
    paths = dict(_read_back(str(tmp_path / "own.pt"))[0])
    assert paths["model.3."] == f"{__name__}.FC3TR" and paths["model.0."] == "models.common.Conv"
