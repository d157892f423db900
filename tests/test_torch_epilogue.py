"""The float convs' epilogue (``ops/cuda/epilogue_kernel.py``,
``csrc/bias_act.cu``) and the rule that sends a conv to it
(``ops/blocks.py`` ``fused_epilogue``), JAX-free.

- On the CPU: the plain version is ``ACTS[act](y + b)`` bit for bit in
  float32 for every activation and channel count; the wrapper checks its
  inputs; the rule keeps ATen's conv, add and activation for the CPU, grad
  on, an int8 conv, the unfused BatchNorm form, an NCHW input, a
  ``torch.jit`` trace, ``torch.export`` and ``FlopCounterMode`` (the rule's
  device check dropped, so that the CPU stands for the card); the network's
  ``epilogue_fused`` / ``epilogue_plain`` counts for the three benchmark
  architectures.
- On the card (``cuda`` marker; skips without one): the kernel is its plain
  version bit for bit for every activation, dtype and channel count, aligned
  and not; a conv, and a whole network, through it are ATen's bit for bit;
  the counts equal the kernel's launches, eager and replayed:

    python -m pytest --noconftest tests/test_torch_epilogue.py -m cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

import yolort_tpu_torch
from yolort_tpu_torch.ops import blocks
from yolort_tpu_torch.ops.cuda import KERNELS, bias_act, bias_act_reference, reset_launch_counts
from yolort_tpu_torch.ops.cuda.epilogue_kernel import ACTS
from yolort_tpu_torch.utils import graphs

CHANNELS = [3, 32, 255, 256]


def operands(c, shape=(2, 7, 9), dtype=torch.float32, seed=0, device="cpu", scale=4.0):
    """y (N, C, H, W) channels_last spanning both signs and Hardswish's
    knees, and a bias (C,)."""
    gen = torch.Generator().manual_seed(seed)
    n, h, w = shape
    y = (torch.randn(n, c, h, w, generator=gen) * scale).to(dtype)
    b = torch.randn(c, generator=gen).to(dtype)
    return y.to(device).contiguous(memory_format=torch.channels_last), b.to(device)


def epilogue_counts(fn):
    """``fn()`` under the profiler, and its ``epilogue_fused`` and
    ``epilogue_plain`` counts in order."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    values = {"epilogue_fused": [], "epilogue_plain": []}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        name = e.name().rsplit("count.", 1)[-1]
        if e.name().startswith("yolort_tpu::count.") and name in values:
            values[name].append(int(e.concrete_inputs()[0]))
    return out, values


# --- on the CPU ----------------------------------------------------------------------------------


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_version_is_the_activation_of_conv_plus_bias(act, c):
    y, b = operands(c, seed=c)
    want = ACTS[act](y + b.view(1, -1, 1, 1))
    got = bias_act_reference(y, b, act)
    assert got.dtype == y.dtype and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    inplace = y.clone()
    assert bias_act(inplace, b, act) is inplace and torch.equal(inplace, want)


def test_the_wrapper_checks_its_inputs():
    y, b = operands(32)
    with pytest.raises(ValueError, match="bias must be"):
        bias_act(y, b[:16], "silu")
    with pytest.raises(ValueError, match="bias must be"):
        bias_act(y, b.double(), "silu")
    with pytest.raises(ValueError, match="act must be"):
        bias_act(y, b, "gelu")
    with pytest.raises(ValueError, match="y must be"):
        bias_act(y.double(), b.double(), "silu")
    with pytest.raises(ValueError, match="y must be"):
        bias_act(y[0], b, "silu")


def test_the_kernel_counts_its_launches_beside_the_others():
    """``bias_act`` is one of ``KERNELS``, the one tuple of hand-written
    kernels whose launches the card's checks count and
    ``reset_launch_counts`` sets to 0; a CPU call launches nothing."""
    assert KERNELS.count(bias_act) == 1
    bias_act.launches = 3
    reset_launch_counts()
    assert bias_act.launches == 0
    y, b = operands(32)
    bias_act(y, b, "silu")
    assert bias_act.launches == 0


class Spy:
    """Stands for ``bias_act_``: counts its calls and applies the plain
    version in place."""

    def __init__(self):
        self.calls = 0

    def __call__(self, y, bias, act):
        self.calls += 1
        return y.copy_(bias_act_reference(y, bias, act))


@pytest.fixture
def cpu_as_card(monkeypatch):
    """The rule with its device check dropped (the CPU stands for the card)
    and a spy in the kernel's place."""
    spy = Spy()
    monkeypatch.setattr(blocks, "eager_on_card", graphs.unintercepted)
    monkeypatch.setattr(blocks, "bias_act_", spy)
    return spy


def small_net(quantized=False, unfused=False):
    gen = torch.Generator().manual_seed(3)
    net = torch.nn.Sequential(blocks.Conv(8, 16, 3, gen=gen),
                              blocks.Conv(16, 16, 1, act="hardswish", gen=gen),
                              blocks.Conv2dOnly(16, 24, 1, gen=gen)).eval()
    if unfused:  # and a bias-free Conv2dOnly
        net[0].init_train(gen)
        net[1].init_train(gen)
        net[2] = blocks.Conv2dOnly(16, 24, 1, bias=False, gen=gen)
    if quantized:
        rng = np.random.default_rng(0)
        for conv in net:
            k, cin, cout = conv.k, conv.weight.shape[1], conv.weight.shape[0]
            conv.set_int8(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8),
                          np.full(cout, 0.01, np.float32), 0.05, None,
                          rng.standard_normal(cout).astype(np.float32))
    return net.requires_grad_(False)


def small_input(nchw=False):
    x = torch.randn(2, 8, 10, 12, generator=torch.Generator().manual_seed(4))
    return x if nchw else x.contiguous(memory_format=torch.channels_last)


def todays(net, x):
    """ATen's conv with its bias, then the activation: the path the rule
    keeps."""
    for conv in net:
        act = getattr(conv, "act", "none")
        x = ACTS[act](F.conv2d(x, conv.weight, conv.bias, conv.s, conv.pad, 1, conv.g))
    return x


@pytest.mark.parametrize("nchw", [False, True])
def test_the_rule_takes_the_kernel_on_the_card(cpu_as_card, nchw):
    """Every biased conv, its output in channels_last whatever the input's
    layout."""
    net, x = small_net(), small_input(nchw)
    with torch.no_grad():
        got = net(x)
        want = todays(net, x)
    assert cpu_as_card.calls == 3 and got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("why", ["cpu", "grad", "quantized", "unfused", "jit_trace", "export",
                                 "flop_counter"])
def test_the_rule_keeps_todays_path(cpu_as_card, monkeypatch, why):
    if why == "cpu":
        monkeypatch.setattr(blocks, "eager_on_card", graphs.eager_on_card)
    net = small_net(quantized=why == "quantized", unfused=why == "unfused")
    x = small_input()
    with torch.no_grad() if why != "grad" else torch.enable_grad():
        if why == "jit_trace":
            torch.jit.trace(net, x, check_trace=False)
        elif why == "export":
            program = torch.export.export(net, (x,))
            targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
            convs = [n for n in program.graph.nodes if "conv2d" in str(n.target)]
            assert len(convs) == 3 and all(n.args[2] is not None for n in convs)
            assert not any("copy_" in t for t in targets)
        elif why == "flop_counter":
            with FlopCounterMode(display=False):
                net(x)
        else:
            got = net(x)
    assert cpu_as_card.calls == 0
    if why in ("cpu", "grad"):
        assert torch.equal(got, todays(net, x))


def test_cpu_tensors_take_todays_path_bit_for_bit():
    """Without the patch the CPU model's network is the conv with its bias
    and ``ACTS``, as before the kernel."""
    net, x = small_net(), small_input()
    with torch.no_grad():
        assert torch.equal(net(x), todays(net, x))


ARCHS = {"yolov5s": (yolort_tpu_torch.yolov5s, 64, 60),
         "yolov5s6": (yolort_tpu_torch.yolov5s6, 64, 79),
         "yolov5ts": (yolort_tpu_torch.yolov5ts, 64, 60)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_network_counts_its_biased_convs_fused_and_plain(monkeypatch, arch):
    """The benchmark cells' architectures: on the CPU every biased float conv
    is plain; with the CPU standing for the card every one is fused, and
    the kernel's stand-in ran once for each."""
    factory, side, n = ARCHS[arch]
    model = factory(device="cpu", size=(side, side)).model
    assert blocks.biased_float_convs(model) == n
    images = torch.rand(1, side, side, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        _, values = epilogue_counts(lambda: model.head_outputs(images))
    assert values == {"epilogue_fused": [0], "epilogue_plain": [n]}
    spy = Spy()
    monkeypatch.setattr(blocks, "eager_on_card", graphs.unintercepted)
    monkeypatch.setattr(blocks, "bias_act_", spy)
    with torch.no_grad():
        _, values = epilogue_counts(lambda: model.head_outputs(images))
    assert values == {"epilogue_fused": [n], "epilogue_plain": [0]} and spy.calls == n


def test_an_int8_models_quantized_convs_are_not_counted():
    """Only the convs the recipe leaves in float (yolov5n: one) count."""
    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    m = yolort_tpu_torch.yolov5n(device="cpu", size=(64, 64)).model
    canvas = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(6))
    q = quantize_compute_params(calibrate_activations(m, [canvas]))
    finalize_scales(q, canvas)
    float_convs = [mod for mod in q.modules()
                   if isinstance(mod, (blocks.Conv, blocks.Conv2dOnly)) and not mod.quantized]
    assert blocks.biased_float_convs(m) == 60 and len(float_convs) < 60
    assert blocks.biased_float_convs(q) == len(float_convs)


# --- on the card ---------------------------------------------------------------------------------


@pytest.fixture
def cuda_device(monkeypatch):
    """The card, TF32 off for the test alone (cuDNN's flag is restored
    after it, so that later tests of the process see their own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda", 0)


def unaligned(t):
    """``t`` (channels_last 4-D or 1-D) copied to storage one element past
    a 16-byte boundary."""
    flat = t.permute(0, 2, 3, 1).reshape(-1) if t.dim() == 4 else t
    base = torch.empty(flat.numel() + 1, dtype=t.dtype, device=t.device)
    base[1:].copy_(flat)
    out = base[1:]
    if t.dim() == 4:
        n, c, h, w = t.shape
        out = out.view(n, h, w, c).permute(0, 3, 1, 2)
        assert out.is_contiguous(memory_format=torch.channels_last)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c", CHANNELS + [1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_bias_act_kernel_matches_plain(cuda_device, act, dtype, c):
    reset_launch_counts()
    launches = 0
    for shape in ((2, 13, 17), (3, 40, 40), (1, 1, 5)):
        y, b = operands(c, shape, dtype, seed=c + shape[1], device=cuda_device)
        want = bias_act_reference(y, b, act)
        for y_off, b_off in ((False, False), (True, False), (False, True), (True, True)):
            target = unaligned(y) if y_off else y.clone(memory_format=torch.channels_last)
            got = bias_act(target, unaligned(b) if b_off else b, act)
            torch.cuda.synchronize()
            launches += 1
            assert got is target and torch.equal(got, want), (shape, y_off, b_off)
    assert bias_act.launches == launches


@pytest.mark.cuda
def test_bias_act_kernel_matches_plain_at_the_tiles_focus_output(cuda_device):
    """The largest output of the benchmark's cells: the tile's Focus conv,
    (16, 32, 640, 640) bfloat16, 420 MB."""
    y, b = operands(32, (16, 640, 640), torch.bfloat16, seed=7, device=cuda_device)
    want = bias_act_reference(y, b, "silu")
    assert torch.equal(bias_act(y, b, "silu"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "hardswish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_a_conv_through_the_kernel_is_atens_bit_for_bit(cuda_device, dtype, act):
    """ATen's conv with its bias, then the activation, in every dtype: the
    kernel rounds where those ops round."""
    gen = torch.Generator().manual_seed(8)
    conv = blocks.Conv(64, 64, 3, act=act, gen=gen)
    conv.bias.data = torch.randn(64, generator=gen)
    conv = conv.to(cuda_device, dtype, memory_format=torch.channels_last).eval()
    x = torch.randn(16, 64, 80, 80, generator=gen).to(cuda_device, dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        reset_launch_counts()
        got = conv(x)
        assert bias_act.launches == 1
        want = ACTS[act](F.conv2d(x, conv.weight, conv.bias, 1, 1))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yolov5n", "yolov5ts"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_networks_outputs_are_atens_bit_for_bit(cuda_device, monkeypatch, arch, dtype):
    """A whole network's head outputs, every biased conv through the kernel,
    against the same network with the rule off (ATen's conv, add and
    activation)."""
    model = getattr(yolort_tpu_torch, arch)(device=cuda_device, dtype=dtype,
                                            size=(256, 256)).model
    images = torch.rand(4, 256, 256, 3, generator=torch.Generator().manual_seed(9)).to(
        cuda_device, dtype)
    with torch.no_grad():
        reset_launch_counts()
        got = [t.clone() for t in model.head_outputs(images)]
        assert bias_act.launches == blocks.biased_float_convs(model) > 0
        monkeypatch.setattr(blocks, "eager_on_card", lambda x: False)
        model._graphs.clear()
        want = model.head_outputs(images)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yolov5n", "yolov5ts"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_counts_equal_the_kernels_launches_eager_and_replayed(cuda_device, arch, dtype):
    """Three calls of one shape: eager, captured, replayed (the TAN model
    eager all three): each call's ``epilogue_fused`` is the kernel's
    launches at that call, and every biased conv fused."""
    model = getattr(yolort_tpu_torch, arch)(device=cuda_device, dtype=dtype,
                                            size=(128, 128)).model
    n = blocks.biased_float_convs(model)
    images = torch.rand(4, 128, 128, 3, device=cuda_device).to(dtype)
    for _ in range(3):
        reset_launch_counts()
        with torch.no_grad():
            _, values = epilogue_counts(lambda: model.head_outputs(images))
        torch.cuda.synchronize()
        assert values == {"epilogue_fused": [n], "epilogue_plain": [0]}
        assert bias_act.launches == n
