"""The network's CUDA graphs (``yolort_tpu_torch/utils/graphs.py``,
``Detector.head_outputs``), JAX-free.

- On the CPU: a model makes no graph, and ``head_outputs``, ``decode`` and
  ``forward`` give the plain network's outputs bit for bit; under the
  profiler every call counts ``graph_replayed`` 0 and nothing counts
  ``graph_captured``.
- The rule and the cache on stand-ins (a CUDA-like input, a capture that
  runs the function once and counts its replays): grad on, ``training``,
  a ``TransformerBlock`` or a forward hook keeps the call eager; a key's
  first call runs eagerly, its second captures, later ones replay; a graph
  captured under ``inference_mode`` replays only there; at most
  ``MAX_GRAPHS`` graphs, the least recently used dropped; a weight moved,
  a dtype changed, a parameter or a layer added drops them, and a module
  built elsewhere or an update in place does not; ``borrow()`` hands out
  the graph's own outputs and a call outside it copies; ``.half()`` on the
  model drops its graphs, a copy starts empty, a thresholds view shares
  the cache.
- On the card (``cuda`` marker; skips without one): detections from a
  replay equal the eager ones bit for bit (f32 480x640 batch 32, bf16 P6
  768x1280 batch 8, int8); one capture and then replays, a new batch size
  capturing anew; a ``no_grad`` call after an ``inference_mode`` capture
  runs and matches; a TAN model stays eager with its attention span; eight
  threads sharing an instance each get their own detections:

    python -m pytest --noconftest tests/test_torch_graphs.py -m cuda
"""

import copy
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

import yolort_tpu_torch
from yolort_tpu_torch.ops.blocks import TransformerBlock
from yolort_tpu_torch.utils import graphs
from yolort_tpu_torch.utils.graphs import MAX_GRAPHS, GraphCache
from yolort_tpu_torch.utils.profiling import shift_head_bias

SIDE = 96


def tiny(device="cpu", **kw):
    m = yolort_tpu_torch.yolov5n(device=device, size=(SIDE, SIDE), score_thresh=0.25,
                                 pre_nms_topk=128, detections_per_img=40, **kw)
    shift_head_bias(m.model, 7.0)
    return m


def frames(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]


def counters(fn):
    """``fn()`` under the profiler, and the values of its ``graph_*`` counts
    by name, in order."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    values = {graphs.REPLAYED: [], graphs.CAPTURED: []}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        name = e.name().rsplit("count.", 1)[-1]
        if e.name().startswith("yolort_tpu::count.") and name in values:
            values[name].append(int(e.concrete_inputs()[0]))
    return out, values


def same_detections(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --- on the CPU ----------------------------------------------------------------------------------


def test_a_cpu_model_makes_no_graph_and_gives_the_plain_outputs():
    m = tiny()
    x = m.canvas(torch.from_numpy(np.stack(frames(1, [(72, 96)] * 2))))[0]
    with torch.inference_mode():
        plain = m.model.head(m.model.features(x))
        for _ in range(3):
            assert all(torch.equal(a, b) for a, b in zip(m.model.head_outputs(x), plain))
        want = m.model.postprocess(plain)
        assert same_detections(m.model(x), want)
        assert same_detections(m.model(x), want)
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(m.model.head_outputs(x), plain))
        assert torch.equal(m.model.decode(x), m.model.decode(x))
    assert len(m.model._graphs) == 0


def test_on_the_cpu_every_call_counts_no_replay_and_nothing_is_captured():
    m = tiny()
    imgs = frames(2, [(72, 96)] * 2)
    _, values = counters(lambda: [m(imgs) for _ in range(3)])
    assert values == {graphs.REPLAYED: [0, 0, 0], graphs.CAPTURED: []}


class CudaLike:
    """The parts of a CUDA tensor the rule and the key read."""

    def __init__(self, shape=(2, 8, 8, 3), dtype=torch.float32, value=0.0):
        self.shape, self.dtype, self.is_cuda = torch.Size(shape), dtype, True
        self.device = torch.device("cuda", 0)
        self.value = value

    def stride(self):
        return tuple(int(s) for s in torch.empty(self.shape).stride())


class StandIn:
    """A capture that runs ``fn`` once and counts its replays; a replay
    writes the input's ``value`` into the outputs, as a graph overwrites
    its outputs."""

    made = []

    def __init__(self, fn, x):
        self.outputs = fn(x)
        self.replays = 0
        self.released = False
        StandIn.made.append(self)

    def replay(self, x):
        self.replays += 1
        for o in self.outputs:
            o.fill_(x.value)

    def release(self):
        self.released = True


class Net(nn.Module):
    def __init__(self, *blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


@pytest.fixture
def stand_in():
    StandIn.made = []
    calls = []

    def fn(x):
        calls.append(x.shape)
        return [torch.full((2,), float(len(calls)))]

    return GraphCache(capture=StandIn), Net(nn.Identity()).eval(), fn, calls


def run_n(cache, net, fn, x, n):
    with torch.no_grad():
        return [cache.run(net, fn, x) for _ in range(n)]


def test_a_key_runs_eagerly_first_then_captures_then_replays(stand_in):
    cache, net, fn, calls = stand_in
    x = CudaLike()
    _, values = counters(lambda: run_n(cache, net, fn, x, 4))
    assert len(calls) == 2 and len(StandIn.made) == 1 and StandIn.made[0].replays == 2
    assert values == {graphs.REPLAYED: [0, 1, 1, 1], graphs.CAPTURED: [1]}
    run_n(cache, net, fn, CudaLike((3, 8, 8, 3)), 2)  # another batch size: its own graph
    assert len(cache) == 2 and len(StandIn.made) == 2


def test_a_graph_captured_in_inference_mode_replays_only_there(stand_in):
    """A graph captured under ``inference_mode`` holds inference tensors,
    which a ``no_grad`` call may not write: that call gets a key of its own."""
    cache, net, fn, calls = stand_in
    x = CudaLike()
    with torch.inference_mode():
        [cache.run(net, fn, x) for _ in range(3)]
    run_n(cache, net, fn, x, 3)
    with torch.inference_mode():
        cache.run(net, fn, x)
    assert len(calls) == 4 and len(cache) == 2
    assert [g.replays for g in StandIn.made] == [2, 1]


@pytest.mark.parametrize("why", ["grad", "training", "transformer", "hook", "cpu"])
def test_the_rule_keeps_the_call_eager(stand_in, why):
    cache, net, fn, calls = stand_in
    x = CudaLike()
    if why == "transformer":
        net = Net(nn.Identity(), TransformerBlock(8, 2, 1, gen=torch.Generator())).eval()
    if why == "hook":
        handle = net.blocks[0].register_forward_hook(lambda *a: None)
    if why == "training":
        net.train()
    if why == "cpu":
        x.is_cuda = False
    if why == "grad":
        with torch.enable_grad():
            outs = [cache.run(net, fn, x) for _ in range(4)]
    else:
        outs = run_n(cache, net, fn, x, 4)
    assert len(calls) == 4 and StandIn.made == [] and len(cache) == 0
    assert [float(o[0][0]) for o in outs] == [1.0, 2.0, 3.0, 4.0]
    if why == "hook":  # without the hook the call engages again
        handle.remove()
        run_n(cache, net, fn, x, 3)
        assert len(calls) == 6 and len(StandIn.made) == 1


def test_at_most_max_graphs_and_the_least_recently_used_goes(stand_in):
    cache, net, fn, _ = stand_in
    xs = [CudaLike((b + 1, 8, 8, 3)) for b in range(MAX_GRAPHS + 1)]
    for x in xs[:MAX_GRAPHS]:
        run_n(cache, net, fn, x, 2)
    run_n(cache, net, fn, xs[0], 1)  # the first is now the most recently used
    run_n(cache, net, fn, xs[-1], 2)
    assert len(cache) == MAX_GRAPHS
    assert [g.released for g in StandIn.made] == [False, True] + [False] * (MAX_GRAPHS - 1)
    run_n(cache, net, fn, xs[1], 1)  # seen before: captured again at once
    assert len(StandIn.made) == MAX_GRAPHS + 2 and StandIn.made[2].released


def weighted(stand_in):
    cache, _, fn, calls = stand_in
    return cache, Net(nn.Linear(2, 2), nn.Identity()).eval(), fn, calls


@pytest.mark.parametrize("change", ["data", "dtype", "parameter", "module", "clear"])
def test_a_change_of_the_weights_drops_the_graphs(stand_in, change):
    cache, net, fn, calls = weighted(stand_in)
    x = CudaLike()
    run_n(cache, net, fn, x, 3)
    linear = net.blocks[0]
    {"data": lambda: setattr(linear.weight, "data", linear.weight.data.clone()),
     "dtype": lambda: linear.double(),
     "parameter": lambda: linear.register_parameter("extra", nn.Parameter(torch.zeros(2))),
     "module": lambda: net.blocks.append(nn.ReLU()),
     "clear": cache.clear}[change]()
    run_n(cache, net, fn, x, 1)
    assert StandIn.made[0].released and len(cache) == 0 and len(calls) == 3
    run_n(cache, net, fn, x, 2)
    assert len(cache) == 1 and len(StandIn.made) == 2


@pytest.mark.parametrize("change", ["elsewhere", "in_place", "same_dtype"])
def test_a_module_built_elsewhere_or_an_update_in_place_keeps_the_graphs(stand_in, change):
    cache, net, fn, calls = weighted(stand_in)
    x = CudaLike()
    run_n(cache, net, fn, x, 2)
    {"elsewhere": lambda: nn.Linear(2, 2).register_forward_hook(lambda *a: None),
     "in_place": lambda: net.blocks[0].weight.data.add_(1.0),
     "same_dtype": lambda: net.to(torch.float32)}[change]()
    run_n(cache, net, fn, x, 2)
    assert len(calls) == 2 and len(StandIn.made) == 1 and StandIn.made[0].replays == 2
    assert not StandIn.made[0].released


def test_borrow_hands_out_the_graphs_outputs_and_a_call_outside_gets_copies(stand_in):
    cache, net, fn, _ = stand_in
    x = CudaLike()
    run_n(cache, net, fn, x, 2)
    own = StandIn.made[0].outputs
    with torch.no_grad():
        with cache.borrow():
            inside = cache.run(net, fn, x)
        outside = cache.run(net, fn, x)
    assert inside is own
    assert outside[0] is not own[0] and torch.equal(outside[0], own[0])


def test_borrow_keeps_other_threads_replays_out_until_it_ends(stand_in):
    """Four threads replay one graph, each on its own input, and read the
    outputs a while after the call inside ``borrow()``: each reads its own."""
    cache, net, fn, _ = stand_in
    xs = [CudaLike(value=float(i)) for i in range(4)]
    run_n(cache, net, fn, xs[0], 2)
    errors = []

    def worker(i):
        for _ in range(10):
            with torch.no_grad(), cache.borrow():
                outs = cache.run(net, fn, xs[i])
                time.sleep(0.001)  # the readers' launches, which another replay must not precede
                if float(outs[0][0]) != i:
                    errors.append((i, float(outs[0][0])))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(StandIn.made) == 1 and StandIn.made[0].replays == 40
    assert not errors, errors[:4]


def test_half_drops_a_models_graphs_a_copy_starts_empty_and_a_view_shares_them(stand_in):
    m = tiny().model
    m._graphs = cache = GraphCache(capture=StandIn)
    fn = stand_in[2]
    run_n(cache, m, fn, CudaLike(), 2)
    assert len(copy.deepcopy(m)._graphs) == 0 and m.with_thresholds(0.5)._graphs is cache
    m.half()
    run_n(cache, m, fn, CudaLike(), 1)
    assert len(cache) == 0 and StandIn.made[0].released


# --- on the card ---------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def eager(model, canvas):
    """The network's kernels launched one by one, then the postprocess."""
    return model.postprocess(model._network(canvas))


def card_case(device, case):
    """(YOLOv5, uint8 frames (B, H, W, 3) on the card) of a bucket the
    benchmark serves."""
    if case == "f32-480x640-b32":
        m = yolort_tpu_torch.yolov5s(device=device, size=(640, 640), score_thresh=0.005,
                                     pre_nms_topk=4096)
        shape = (32, 480, 640, 3)
    else:
        m = yolort_tpu_torch.yolov5s6(device=device, dtype=torch.bfloat16, size=(1280, 1280),
                                      score_thresh=0.25, pre_nms_topk=512)
        shape = (8, 720, 1280, 3)
    shift_head_bias(m.model, 7.0)
    gen = torch.Generator(device=device).manual_seed(5)
    return m, torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32-480x640-b32", "bf16-p6-768x1280-b8"])
def test_a_replay_gives_the_eager_detections_bit_for_bit(cuda_device, case):
    m, raw = card_case(cuda_device, case)
    canvas = m.canvas(raw)[0]
    other = m.canvas(raw.flip(0))[0]
    with torch.inference_mode():
        want, want_other = eager(m.model, canvas), eager(m.model, other)
        got = [m.model(c) for c in (canvas, other, canvas, other, canvas)]
        heads = m.model.head_outputs(canvas)
        plain = m.model._network(canvas)
    assert len(m.model._graphs) == 1 and int(want.num.min()) > 0
    for g, w in zip(got, [want, want_other] * 3):
        assert same_detections(g, w)
    assert all(torch.equal(a, b) for a, b in zip(heads, plain))


@pytest.mark.cuda
def test_one_capture_then_replays_and_a_new_batch_size_captures_anew(cuda_device):
    m = tiny(cuda_device)
    two, three = frames(3, [(72, 96)] * 2), frames(4, [(72, 96)] * 3)
    wants = [m.model.postprocess(m.model._network(m.canvas(torch.from_numpy(np.stack(f))
                                                            .to(cuda_device))[0]))
             for f in (two, three)]
    m.model._graphs.clear()
    (outs, values) = counters(lambda: [m(two) for _ in range(4)] + [m(three) for _ in range(3)])
    assert values == {graphs.REPLAYED: [0, 1, 1, 1, 0, 1, 1], graphs.CAPTURED: [1, 1]}
    assert len(m.model._graphs) == 2
    for out, want in zip(outs, [wants[0]] * 4 + [wants[1]] * 3):
        for j, d in enumerate(out):
            n = int(want.num[j])
            assert np.array_equal(d["scores"], want.scores[j, :n].float().cpu().numpy())


@pytest.mark.cuda
def test_a_no_grad_call_after_an_inference_mode_capture_runs_and_matches(cuda_device):
    """A graph captured under ``inference_mode`` is not replayed by a
    ``no_grad`` call of the same shape, whose input it could not take."""
    m = tiny(cuda_device)
    canvas = m.canvas(torch.from_numpy(np.stack(frames(3, [(72, 96)] * 2))).to(cuda_device))[0]
    with torch.inference_mode():
        want = [o.clone() for o in m.model._network(canvas)]
        [m.model.head_outputs(canvas) for _ in range(3)]
    with torch.no_grad():
        got = [m.model.head_outputs(canvas.clone()) for _ in range(3)]
    assert len(m.model._graphs) == 2
    assert all(torch.equal(a, b) for g in got for a, b in zip(g, want))


@pytest.mark.cuda
def test_a_tan_model_stays_eager_and_keeps_its_attention_span(cuda_device):
    m = yolort_tpu_torch.yolov5ts(device=cuda_device, size=(128, 128), score_thresh=0.25)
    imgs = frames(5, [(128, 128)] * 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [m(imgs) for _ in range(3)]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("yolort_tpu::span.attention") == 3
    assert len(m.model._graphs) == 0 and len(outs) == 3


@pytest.mark.cuda
def test_threads_sharing_an_instance_on_the_card_each_get_their_own_detections(cuda_device):
    """Eight threads call one model on their own canvases of one shape: each
    replay's outputs are read by its own postprocess, never overwritten
    first by another thread's replay."""
    m = tiny(cuda_device)
    canvases = [m.canvas(torch.from_numpy(np.stack(frames(20 + i, [(72, 96)] * 2)))
                         .to(cuda_device))[0] for i in range(8)]
    with torch.inference_mode():
        wants = [eager(m.model, c) for c in canvases]
        for c in canvases[:2]:  # eager, then the capture
            m.model(c)
    errors = []

    def worker(i):
        try:
            with torch.inference_mode():
                for _ in range(8):
                    assert same_detections(m.model(canvases[i]), wants[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(canvases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(m.model._graphs) == 1
    assert not errors, errors[0]
    # the head outputs read a while after the call, inside borrow(): each thread its own
    with torch.inference_mode():
        heads = [m.model._network(c) for c in canvases]

    def reader(i):
        try:
            with torch.inference_mode():
                for _ in range(8):
                    with m.model._graphs.borrow():
                        outs = m.model.head_outputs(canvases[i])
                        time.sleep(0.002)
                        got = [o.clone() for o in outs]
                    assert all(torch.equal(a, b) for a, b in zip(got, heads[i]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(len(canvases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    # through the instance's __call__ as well: the arena, the graph and the readback
    requests = [frames(40 + i, [(72, 96)] * 2) for i in range(8)]
    want_calls = [m(r) for r in requests]
    results = [None] * 8
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, m(requests[i])))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for got, want in zip(results, want_calls):
        assert got is not None
        for g, w in zip(got, want):
            assert all(np.array_equal(g[k], w[k]) for k in w)


@pytest.mark.cuda
def test_an_int8_network_replays_its_eager_run_bit_for_bit(cuda_device):
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    m = yolort_tpu_torch.yolov5s(device=cuda_device, size=(SIDE, SIDE), score_thresh=0.25)
    shift_head_bias(m.model, 7.0)
    canvas = m.canvas(torch.from_numpy(np.stack(frames(6, [(96, 96)] * 4))).to(cuda_device))[0]
    with torch.no_grad():
        q = quantize_compute_params(calibrate_activations(m.model, [canvas]))
        finalize_scales(q, canvas[:1])
        want = eager(q, canvas)
        counts = []
        got = []
        for _ in range(4):
            reset_launch_counts()
            got.append(q(canvas))
            torch.cuda.synchronize()
            counts.append({fn.__name__: fn.launches for fn in KERNELS if fn.launches})
    assert len(q._graphs) == 1 and int(want.num.min()) > 0
    assert all(same_detections(g, want) for g in got)
    assert counts[0]["qconv1x1"] > 0 and all(c == counts[0] for c in counts)
