"""The request path's spans and counters (``yolort_tpu_torch/utils/profiling.py``)
and the benchmark's readers of them (``portbench/layers/_program.py``), JAX-free.

- Under ``torch.profiler`` each ``YOLOv5.__call__`` gives one
  ``span.request`` holding ``stack``, ``upload``, ``letterbox``,
  ``network``, ``postprocess`` (``cells``, ``select``, ``nms``),
  ``rescale`` and ``readback``, on the shape-bucket path and on the
  ``fixed_shape`` mixed path; every span and counter is a ``cpu_op``,
  never a user annotation, in ``utils.profiling.trace``'s Chrome trace.
- ``count.kept`` is the returned boxes, ``count.candidates`` the valid
  pairs that entered NMS.  With the profiler off no RecordFunction is
  entered and no count kept; the outputs are bit-identical on and off;
  the exported serving pipeline holds no profiler node.
- Each reader of ``portbench/layers`` on a hand-built trace: known values
  in, known values out, idle that adds up, None without device events or
  without program spans; the program's spans leave the benchmark's
  ``per_batch_ms``, ``idle_pct`` and ``roofline_pct`` as they were.
- On the card (``cuda`` marker; skips without one), a traced run of the
  benchmark's tiny cell: no span on the device, no copy to the host or
  synchronisation launched in ``letterbox`` / ``network`` /
  ``postprocess`` / ``rescale``, every copy to the card one pinned copy a
  call launched in ``upload`` (``count.staged`` once a readback), the
  held counts read in ``readback``, the network one ``cudaGraphLaunch`` a
  call in its span (``graph_replay.batch`` 100):

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda
"""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import yolort_tpu_torch
from yolort_tpu_torch.models.ensemble import Ensemble
from yolort_tpu_torch.models.yolov5 import YOLOv5
from yolort_tpu_torch.ops import nms as TN
from yolort_tpu_torch.ops.blocks import biased_float_convs
from yolort_tpu_torch.utils import profiling
from yolort_tpu_torch.utils.profiling import shift_head_bias

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.layers import _device, _program  # noqa: E402
from portbench.spec import Benchmark, Bounds  # noqa: E402
from portbench.trace import parse  # noqa: E402

SIDE = 96
FIXED = (96, 96)
MIXED = [(72, 96), (96, 64), (50, 80)]
# the request's children in order, on either path (two stacks: the frames'
# checks, then the batch)
CHILDREN = ["stack", "stack", "upload", "letterbox", "network", "postprocess", "rescale",
            "readback"]
LAUNCHING = {"letterbox", "network", "postprocess", "cells", "select", "nms"}
BOTH_READERS = ["stack_ms", "readback_ms", "network_host_ms", "postprocess_host_ms",
                "idle_launch_ms", "idle_between_ms", "nms_yield", "staging_reuse", "graph_replay",
                "epilogue_fused"]
BATCH_READERS = BOTH_READERS + ["select_ms", "nms_ms"]
NEW_READERS = ([f"{n}.batch" for n in BATCH_READERS]
               + [f"{n}.stream" for n in BOTH_READERS])


def tiny(fixed=None, device="cpu"):
    m = yolort_tpu_torch.yolov5n(device=device, size=(SIDE, SIDE), fixed_shape=fixed,
                                 score_thresh=0.25, pre_nms_topk=128, detections_per_img=40)
    shift_head_bias(m.model, 7.0)
    return m


def frames(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]


PATHS = {"bucket": (None, [(72, 96)] * 2), "fixed_mixed": (FIXED, MIXED),
         "ensemble": (None, [(72, 96)] * 2)}


@pytest.fixture(scope="module", params=list(PATHS))
def served(request):
    """(model, frames): the shape-bucket path, the ``fixed_shape`` mixed
    path, and the decoded-prediction path (an ``Ensemble``, no stage-1
    table)."""
    fixed, shapes = PATHS[request.param]
    m = tiny(fixed)
    if request.param == "ensemble":
        m = YOLOv5(model=Ensemble([m.model, tiny().model]), size=(SIDE, SIDE))
    return m, frames(1, shapes)


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), list(e.concrete_inputs()))
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("yolort_tpu::span.", "yolort_tpu::count."))]
    return out, sorted(events, key=lambda e: (e[1], -e[2]))


def parent_of(events, ev):
    """The innermost other span holding ``ev``."""
    holders = [p for p in events if p is not ev and p[0].startswith("yolort_tpu::span.")
               and p[1] <= ev[1] and ev[2] <= p[2]]
    return max(holders, key=lambda p: p[1], default=None)


def short(name):
    return name.split("::", 1)[1].split(".", 1)[1]


def test_each_call_gives_one_request_with_its_spans_nested(served):
    m, imgs = served
    _, events = profiled(lambda: [m(imgs), m(imgs)])
    requests = [e for e in events if e[0] == "yolort_tpu::span.request"]
    assert len(requests) == 2
    assert requests[1][3][0] == requests[0][3][0] + 1  # the per-instance sequence number
    for req in requests:
        inside = [e for e in events if e is not req and parent_of(events, e) is req]
        spans = [short(e[0]) for e in inside if e[0].startswith("yolort_tpu::span.")]
        assert spans == CHILDREN
        post = next(e for e in inside if e[0] == "yolort_tpu::span.postprocess")
        below = [short(e[0]) for e in events if parent_of(events, e) is post]
        assert below == (["select", "nms"] if isinstance(m.model, Ensemble)
                         else ["cells", "select", "nms"])
        counts = [e for e in events if e[0].startswith("yolort_tpu::count.")
                  and req[1] <= e[1] <= req[2]]
        readback = next(e for e in inside if e[0] == "yolort_tpu::span.readback")
        network = ("graph_replayed", "epilogue_fused", "epilogue_plain")
        held = [c for c in counts if short(c[0]) not in network]
        assert [short(c[0]) for c in held] == ["candidates", "kept"]
        assert all(parent_of(events, c) is readback for c in held)
        # one of each network count a network run (an Ensemble runs two), in span network: on
        # the CPU no replay, and every biased float conv's epilogue ATen's
        runs = 2 if isinstance(m.model, Ensemble) else 1
        for name in network:
            found = [c for c in counts if short(c[0]) == name]
            assert len(found) == runs
            assert all(short(parent_of(events, c)[0]) == "network" for c in found)
            total = sum(c[3][0] for c in found)
            assert total == (biased_float_convs(m.model) if name == "epilogue_plain" else 0)


def test_spans_and_counters_are_cpu_ops_in_the_chrome_trace(tmp_path):
    m = tiny()
    imgs = frames(2, [(72, 96)] * 2)
    with profiling.trace(str(tmp_path / "tr")):
        out = m(imgs)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    ours = [e for e in events if str(e.get("name", "")).startswith("yolort_tpu::")
            and str(e["name"]).split("::")[1].startswith(("span.", "count."))]
    assert {short(e["name"]) for e in ours} >= set(CHILDREN) | {"request", "cells", "select",
                                                                "nms", "candidates", "kept"}
    assert {e.get("cat") for e in ours} == {"cpu_op"}
    assert not any("annotation" in str(e.get("cat", "")) and "yolort_tpu" in str(e.get("name"))
                   for e in events)
    # trace() records the inputs, so a counter's value is in the trace
    kept = next(e for e in ours if e["name"] == "yolort_tpu::count.kept")
    assert str(sum(len(o["boxes"]) for o in out)) in json.dumps(kept["args"])


def test_counts_are_the_returned_boxes_and_the_valid_pairs(served, monkeypatch):
    m, imgs = served
    valid = []
    real = TN._nms_and_compact

    def spy(cand_boxes, top_scores, labels, ok, **kw):
        valid.append(int(ok.sum()))
        return real(cand_boxes, top_scores, labels, ok, **kw)

    monkeypatch.setattr(TN, "_nms_and_compact", spy)
    out, events = profiled(lambda: m(imgs))
    values = {short(e[0]): e[3][0] for e in events if e[0].startswith("yolort_tpu::count.")}
    assert values["kept"] == sum(len(o["boxes"]) for o in out) > 0
    assert valid == [values["candidates"]] and values["candidates"] > values["kept"]


def test_with_the_profiler_off_no_record_function_is_entered(served, monkeypatch):
    m, imgs = served
    want = m(imgs)

    def refuse(*a, **kw):
        raise AssertionError("a RecordFunction was entered with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not profiling.recording()
    got = m(imgs)
    assert getattr(profiling._held, "counts", None) is None
    for g, w in zip(got, want):
        assert all(np.array_equal(g[k], w[k]) for k in w)


def test_outputs_are_bit_identical_with_tracing_on_and_off(served):
    m, imgs = served
    off = m(imgs)
    on, events = profiled(lambda: m(imgs))
    assert events
    assert len(on) == len(off) == len(imgs)
    for a, b in zip(on, off):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("traced", [False, True])
def test_the_exported_serving_pipeline_holds_no_profiler_node(traced):
    from yolort_tpu_torch.runtime.aot import export_program

    m = tiny()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            _, ep = export_program(m.model, batch_size=1, input_hw=(SIDE, SIDE))
    else:
        _, ep = export_program(m.model, batch_size=1, input_hw=(SIDE, SIDE))
    targets = [str(n.target) for n in ep.graph.nodes]
    assert any("yolort_tpu.nms_mask" in t for t in targets)
    assert not any("profiler" in t or "record_function" in t or "span." in t for t in targets)


# --- the readers, on a hand-built trace --------------------------------------------------------

US = 1000  # the hand-built timeline is in microseconds, on the profiler's ns clock


class Ev:
    """A profiler event as ``portbench.trace.parse`` reads one."""

    def __init__(self, name, start, end, cuda=False, corr=0, inputs=(), shapes=(), dtypes=()):
        self._n, self._s, self._d = name, start * US, (end - start) * US
        self._cuda, self._corr = cuda, corr
        self._inputs, self._shapes, self._dtypes = list(inputs), list(shapes), list(dtypes)

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0

    def shapes(self):
        return self._shapes

    def dtypes(self):
        return self._dtypes

    def concrete_inputs(self):
        return self._inputs


def request_events(t, corr, program=True, grown=False, replayed=1, fused=(60, 0)):
    """One call at ``t`` us: the benchmark's spans, the program's, launches
    and their device work (one kernel launched in each layer); the staging
    arena grown in its ``stack`` where ``grown``; the network's
    ``graph_replayed`` count ``replayed`` and its ``epilogue_fused`` /
    ``epilogue_plain`` counts ``fused``."""
    def launch(at, start, end, name="kernel", api="cudaLaunchKernel"):
        nonlocal corr
        corr += 1
        return [Ev(api, t + at, t + at + 1, corr=corr), Ev(name, t + start, t + end, True, corr)]

    evs = [Ev("portbench.request", t, t + 100), Ev("portbench.letterbox", t + 20, t + 30),
           Ev("portbench.network", t + 30, t + 60), Ev("portbench.postprocess", t + 60, t + 80),
           Ev("yolort_tpu::nms_mask", t + 73, t + 78, shapes=[[2, 512, 4], [2, 512], [], [], []],
              dtypes=["float", "bool"], inputs=[None, None, 0.45, 256, 300])]
    evs += launch(12, 14, 24, "Memcpy HtoD (Pageable -> Device)", "cudaMemcpyAsync")
    evs += launch(22, 24, 28) + launch(32, 32, 50) + launch(45, 50, 58)
    evs += launch(62, 62, 64) + launch(66, 66, 70) + launch(74, 75, 77)
    evs += launch(86, 86, 88, "Memcpy DtoH (Device -> Pageable)", "cudaMemcpyAsync")
    if program:
        spans = [("request", 1, 99), ("stack", 2, 10), ("upload", 10, 20), ("letterbox", 20, 30),
                 ("network", 30, 60), ("postprocess", 60, 80), ("cells", 61, 65),
                 ("select", 65, 72), ("nms", 72, 79), ("rescale", 80, 85),
                 ("readback", 85, 98)]
        evs += [Ev("yolort_tpu::span." + n, t + s, t + e) for n, s, e in spans]
        evs += [Ev("yolort_tpu::count.staged", t + 11, t + 11, inputs=[1]),
                Ev("yolort_tpu::count.candidates", t + 96, t + 96, inputs=[50]),
                Ev("yolort_tpu::count.kept", t + 97, t + 97, inputs=[20]),
                Ev("yolort_tpu::count.graph_replayed", t + 31, t + 31, inputs=[replayed]),
                Ev("yolort_tpu::count.epilogue_fused", t + 59, t + 59, inputs=[fused[0]]),
                Ev("yolort_tpu::count.epilogue_plain", t + 59, t + 59, inputs=[fused[1]])]
        if grown:
            evs.append(Ev("yolort_tpu::count.staging_grown", t + 5, t + 5, inputs=[1]))
    return evs


def hand_run(program=True, device=True, counts=True):
    evs = (request_events(0, 0, program, grown=True, replayed=0, fused=(45, 15))
           + request_events(100, 100, program))
    if not device:
        evs = [e for e in evs if not e._cuda]
    if not counts:
        evs = [e for e in evs if not e.name().startswith("yolort_tpu::count.")]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: evs)))
    bench = Benchmark(ROOT)
    cell = bench.cell("s640-eval-b32")
    return SimpleNamespace(trace=parse(prof), batches=2, cell=cell, bounds=Bounds(),
                           canvas=(480, 640), flops_per_image=1.0, window_s=200e-6,
                           images_done=64)


def read(name, run):
    bench = Benchmark(ROOT)
    metric = next(m for m in bench.metrics if m.name == name)
    return bench.reader(metric).read(run)


# per batch, from the timeline above: host spans; device work launched in
# select (66: 4 us) and nms (74: 2 us); idle gaps 0-14 (before the request
# span), 28-32 letterbox, 58-62 network, 64-66 cells, 70-75 select, 77-86
# nms, 88-114 readback, then the second call's, its last 188-200 readback
WANT_MS = {"stack_ms": 0.008, "readback_ms": 0.013, "network_host_ms": 0.030,
           "postprocess_host_ms": 0.020, "select_ms": 0.004, "nms_ms": 0.002,
           "idle_launch_ms": 0.024, "idle_between_ms": 0.026}


@pytest.mark.parametrize("name", NEW_READERS)
def test_each_reader_reads_its_known_value(name):
    run = hand_run()
    base = name.split(".")[0]
    # two groups staged, the arena grown for one of them; the first call eager, the second
    # a replay; 45 of 60 biased convs fused, then all 60
    want = {"nms_yield": 40.0, "staging_reuse": 50.0, "graph_replay": 50.0,
            "epilogue_fused": 87.5, **WANT_MS}[base]
    assert read(name, run) == pytest.approx(want, rel=1e-9)


def test_idle_adds_up_to_the_windows_idle():
    run = hand_run()
    idle = _device.idle_pct(run)
    assert idle == pytest.approx(50.0)
    lo, hi = run.trace.window
    total_ms = (read("idle_launch_ms.batch", run) + read("idle_between_ms.batch", run)) * 2
    assert total_ms == pytest.approx(idle / 100 * (hi - lo) / 1e6, rel=1e-12)


@pytest.mark.parametrize("name", NEW_READERS)
def test_readers_give_none_without_device_events_or_program_spans(name):
    assert read(name, hand_run(device=False)) is None
    assert read(name, hand_run(program=False)) is None
    assert read(name, SimpleNamespace(trace=None, batches=2)) is None


@pytest.mark.parametrize("name", ["graph_replay.batch", "graph_replay.stream"])
def test_graph_replay_reads_none_without_its_counter(name):
    """A program that counts no ``graph_replayed`` (the parent's) reads None."""
    assert read(name, hand_run(counts=False)) is None


@pytest.mark.parametrize("name", ["epilogue_fused.batch", "epilogue_fused.stream"])
def test_epilogue_fused_reads_none_without_its_counters(name):
    """A program that counts no epilogue (the parent's) reads None, and so
    does a window whose calls counted no biased conv."""
    assert read(name, hand_run(counts=False)) is None
    evs = request_events(0, 0, fused=(0, 0))
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: evs)))
    assert read(name, SimpleNamespace(trace=parse(prof), batches=1)) is None


def test_program_spans_leave_the_benchmarks_own_metrics_as_they_were():
    with_spans, without = hand_run(), hand_run(program=False)
    assert len(with_spans.trace.device) == len(without.trace.device) == 16
    assert not any(d.name.startswith("yolort_tpu::") for d in with_spans.trace.device)
    assert with_spans.trace.spans == without.trace.spans
    for span in ("portbench.letterbox", "portbench.network", "portbench.postprocess"):
        assert _device.per_batch_ms(with_spans, span) == _device.per_batch_ms(without, span)
    assert _device.per_batch_ms(with_spans, "portbench.network") == pytest.approx(0.026)
    for fn in (_device.idle_pct, _device.roofline_pct, _device.upload_ms):
        assert fn(with_spans) == fn(without) and fn(without) is not None
    assert with_spans.trace.idle_by_span() == without.trace.idle_by_span()


def test_the_timeline_finds_the_innermost_span():
    tl = _program.Timeline([("request", 0, 100), ("postprocess", 10, 50), ("select", 20, 30),
                            ("nms", 30, 40), ("readback", 60, 90)])
    at = {t: tl.at(t) for t in (-1, 0, 5, 15, 25, 35, 45, 55, 70, 95, 101)}
    assert at == {-1: None, 0: "request", 5: "request", 15: "postprocess", 25: "select",
                  35: "nms", 45: "postprocess", 55: "request", 70: "readback", 95: "request",
                  101: None}


# --- on the card -------------------------------------------------------------------------------

SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tiny_root(tmp_path):
    """The benchmark's CPU-test cell (``portbench/tests/conftest.py``), in a
    copy of the benchmark's files."""
    spec = importlib.util.spec_from_file_location("portbench_tiny_cell",
                                                  ROOT / "portbench/tests/conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_tiny_root(tmp_path), mod.TINY_CELL


@pytest.mark.cuda
def test_a_traced_run_on_the_card_keeps_the_spans_off_the_device(cuda_device, tmp_path,
                                                                 monkeypatch):
    import portbench.trace as ptrace
    from portbench import run as run_mod

    root, cell_name = _tiny_root(tmp_path)
    seen = {}
    real = ptrace.parse

    def spy(prof):
        seen["host"] = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
                        if e.device_type() != DeviceType.CUDA]
        seen["trace"] = real(prof)
        return seen["trace"]

    monkeypatch.setattr(ptrace, "parse", spy)
    bench = Benchmark(root, root / "portbench")
    res = run_mod.run_cell(bench, bench.cell(cell_name), 2 ** 33 + 17, 2.0, True, device="cuda")
    tr = seen["trace"]
    assert res["correct"] is True and res["failed"] == 0
    assert not any(d.name.startswith("yolort_tpu::") for d in tr.device)
    assert not any(n.startswith("yolort_tpu::") for n, _ in res["breakdown"]["device_ops"])
    spans = _program.spans(SimpleNamespace(trace=tr, batches=res["attempted"]))
    tl = _program.Timeline(spans)
    lo, hi = tr.window
    syncs = [t for n, t in seen["host"] if n in SYNCS and lo <= t <= hi]
    assert syncs and not any(tl.at(t) in LAUNCHING for t in syncs)
    assert not any(tl.at(t) == "rescale" for t in syncs)
    # the frames and sizes reach the card in one pinned copy a call, launched in upload
    htod = [d for d in tr.device if "HtoD" in d.name and d.launch is not None
            and lo <= d.launch <= hi]
    assert htod and all("Pinned" in d.name and tl.at(d.launch) == "upload" for d in htod)
    dtoh = [d.launch for d in tr.device if "DtoH" in d.name and d.launch is not None
            and lo <= d.launch <= hi]
    assert dtoh and all(tl.at(t) == "readback" for t in dtoh)
    readbacks = [s for s in spans if s[0] == "readback" and lo <= s[1] <= hi]
    counts = [o for o in tr.ops if o.name == "count.candidates" and lo <= o.start <= hi]
    assert len(counts) == len(readbacks) and all(tl.at(o.start) == "readback" for o in counts)
    staged = [o for o in tr.ops if o.name == "count.staged" and lo <= o.start <= hi]
    assert len(staged) == len(readbacks) and all(tl.at(o.start) == "upload" for o in staged)
    assert len(htod) == len(readbacks)
    # four copies of the detections and one of the held counts in each readback
    for _, s, e in readbacks:
        assert sum(s <= t <= e for t in dtoh) == 5
    metrics = res["metrics"]
    assert {f"{n}.batch" for n in BATCH_READERS} <= set(metrics)
    assert metrics["staging_reuse.batch"]["value"] == 100.0  # grown only in the warm-up
    # the network is one graph launch a call, launched in its span (captured in the warm-up)
    graph_launches = [t for n, t in seen["host"] if n == "cudaGraphLaunch" and lo <= t <= hi]
    assert len(graph_launches) == len(readbacks)
    assert all(tl.at(t) == "network" for t in graph_launches)
    assert metrics["graph_replay.batch"]["value"] == 100.0
    batches = res["attempted"] - res["failed"]
    idle_ms = metrics["device_idle.batch"]["value"] / 100 * res["device"]["window_s"] * 1e3
    total = (metrics["idle_launch_ms.batch"]["value"]
             + metrics["idle_between_ms.batch"]["value"]) * batches
    assert total == pytest.approx(idle_ms, rel=1e-6)
