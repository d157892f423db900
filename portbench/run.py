"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``: from the process's start to the window's start,
less the benchmark's own reference work): torch, the frames made from
the seed on the card, the weights written as an ultralytics checkpoint
and loaded through the port's ``YOLOv5.load_from_yolov5``, the kernel
library (built once per checkout, in ``build/``), and a warm-up on the
cell's own shapes.  Making the weights (``weights.py``: the reference
network's BatchNorm statistics, the candidate calibration, the FLOP
count) is the benchmark's work, not the program's, and is left out of
``setup_s``.  Then
``--seconds`` of the cell's traffic through ``YOLOv5.__call__``, with the
profiler on under ``--trace 1``.  After the window the kept outputs are
judged against the plain reference (``judge.py``), and the last line of
standard output is the result, as JSON.

``--control 1`` runs the configuration's lower-precision control in the
program's place (``control`` in the configuration's file): the benchmark's
own runs never pass it.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()


def _since_process_start() -> float:
    """Seconds the process ran before this module was imported (Linux;
    0 where /proc is not there)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK") - (time.perf_counter() - _T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


_PRE_START = _since_process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / "build" / "portbench" / sub)


def pin_host() -> None:
    """The run's process on one core, the same in every run (the third
    of those it may use), so a host-bound cell's calls do not move
    between cores."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[min(2, len(cores) - 1)]})


@dataclass
class Record:
    req: int
    start: float
    end: float
    images: int
    ok: bool
    out: Optional[list]


class Client:
    """What a load kind drives: ``call(i)`` serves request ``i`` of the
    pool through ``__call__`` and records it."""

    def __init__(self, call: Callable, pool, traffic: dict, span: Optional[Callable] = None):
        self._call = call
        self.pool = pool
        self.traffic = traffic
        self.clock = time.perf_counter
        self._span = span

    def call(self, i: int) -> Record:
        frames = self.pool[i]
        start = self.clock()
        try:
            if self._span is not None:
                with self._span():
                    out = self._call(frames)
            else:
                out = self._call(frames)
            ok = True
        except Exception as e:  # a failed call is counted, not fatal  # noqa: BLE001
            print(f"call failed: {type(e).__name__}: {e}", file=sys.stderr)
            out, ok = None, False
        return Record(i, start, self.clock(), len(frames), ok, out)


@dataclass
class Run:
    """What the metric readers read."""

    cell: object
    t0: float
    records: List[Record]
    flops_per_image: float
    bounds: object
    setup_s: float
    canvas: tuple
    trace: object = None

    @property
    def window_s(self) -> float:
        return max(r.end for r in self.records) - self.t0

    @property
    def images_done(self) -> int:
        return sum(r.images for r in self.records if r.ok)

    @property
    def batches(self) -> int:
        return sum(1 for r in self.records if r.ok)


def _sample(records: List[Record], n: int, seed: int) -> List[int]:
    """Indices of the judged calls: ``n`` drawn from the seed, with the
    first and the last."""
    import numpy as np

    k = len(records)
    picks = set(np.random.default_rng(int(seed) + 2).choice(k, size=min(n, k), replace=False).tolist())
    return sorted(picks | {0, k - 1})


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, program_hook: Optional[Callable] = None,
             t_start: float = _T_START, pre_start: float = _PRE_START) -> dict:
    """One run of ``cell``; returns the result object (with ``checks``)."""
    import torch

    from portbench import frames as frames_mod, judge, program, weights
    from portbench.reference import pipeline
    from portbench.reference.arith import forward_flops
    from portbench.spec import Bounds
    from portbench.trace import parse

    cfg, traffic = cell.config, cell.traffic
    reference = bench.reference(cfg)
    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fixed = traffic.get("fixed_shape")
    fixed = None if fixed is None else tuple(fixed)
    marks = [("start", t_start - pre_start), ("imports", time.perf_counter())]
    pool = frames_mod.make_pool(traffic, seed, dev)
    # cuDNN is loaded here, so its one-time cost counts in set-up, not in
    # the reference's span below
    torch.nn.functional.conv2d(torch.zeros((1, 1, 4, 4), device=dev), torch.zeros((1, 1, 3, 3), device=dev))
    marks.append(("frames", time.perf_counter()))

    net = reference.build(cfg).to(dev)
    flat_frames = [f for req in pool for f in req]
    stat = [torch.from_numpy(f).to(dev) for f in flat_frames[:8]]
    plans = [pipeline.plan(tuple(f.shape[:2]), tuple(cfg["size"]), int(cfg["size_divisible"]), fixed)
             for f in stat]
    stat_x = torch.stack([pipeline.letterbox(f, p) for f, p in zip(stat, plans)
                          if p.canvas == plans[0].canvas])
    shift = weights.make(net, seed, stat_x, [torch.from_numpy(f).to(dev) for f in flat_frames],
                         cfg, fixed, head_logits=reference.head_logits)
    flops = forward_flops(lambda x: reference.head_logits(net, x),
                          torch.zeros((1, 3, *plans[0].canvas), device=dev))
    del stat, stat_x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("weights", time.perf_counter()))
    reference_s = marks[-1][1] - marks[-2][1]

    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ckpt = os.path.join(tmp, "weights.pt")
        reference.save_checkpoint(net, ckpt)
        m = program.build(ckpt, cfg, traffic, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    marks.append(("checkpoint", time.perf_counter()))
    if control:
        if cfg["control"] == "tf32":
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
        elif cfg["control"] == "int8":
            program.int8_control(m, pool[:2])
        else:
            raise ValueError(f"unknown control {cfg['control']!r}")
    call = m if program_hook is None else program_hook(m)

    span = None
    if trace:
        from torch.profiler import record_function

        program.install_spans(m)
        span = lambda: record_function(program.REQUEST_SPAN)  # noqa: E731
    client = Client(call, pool, traffic, span)
    load = bench.load_kind(traffic)
    load.warmup(client)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("warmup", time.perf_counter()))
    setup_s = pre_start + marks[-1][1] - t_start - reference_s
    print("set-up by part (s): " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                                              in zip(marks, marks[1:]))
          + f"; setup_s {setup_s:.3f} leaves out the weights' {reference_s:.3f}", file=sys.stderr)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts, record_shapes=True) as prof:
            t0, records = load.window(client, seconds, seed)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    else:
        t0, records = load.window(client, seconds, seed)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    if control:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    run = Run(cell, t0, records, float(flops), Bounds(bench.dir), setup_s, plans[0].canvas)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    kind = "per_layer" if trace else "end_to_end"
    if trace:
        run.trace = parse(prof)
        print(f"trace: {len(run.trace.device)} device events, "
              f"{sum(d.launch is not None for d in run.trace.device)} with their launch, "
              f"{len(run.trace.ops)} dispatcher ops, {len(run.trace.spans)} spans", file=sys.stderr)
        del prof
        lo, hi = run.trace.window
        device_info["busy_s"] = run.trace.busy_ns() / 1e9
        device_info["window_s"] = (hi - lo) / 1e9
        totals: Dict[str, int] = {}
        for d in run.trace.device:
            if d.end > lo and d.start < hi:
                totals[d.name] = totals.get(d.name, 0) + d.end - d.start
        breakdown = {
            "device_ops": [[n, ns / 1e9] for n, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, ns / 1e9] for n, ns in sorted(run.trace.idle_by_span().items(),
                                                            key=lambda kv: -kv[1])[:10]],
        }
    metrics = {}
    for metric in bench.metrics_of(cell.name, kind):
        value = bench.reader(metric).read(run)
        if value is not None:
            metrics[metric.name] = {"value": float(value), "unit": metric.unit}

    # the program's state goes before the reference runs
    outputs = [(r.req, r.out, r.ok) for r in records]
    del m, call, client, run.trace
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = json.loads((bench.dir / "limits" / f"{cell.name}.json").read_text())
    picks = _sample(records, int(traffic["judged_calls"]), seed)
    tally = judge.Tally(float(limits.get("bad_score", "inf")), float(limits.get("bad_box", "inf")))
    failed_judged = 0
    refs: Dict[int, list] = {}
    for i in picks:
        req, out, ok = outputs[i]
        if not ok:
            failed_judged += 1
            continue
        if req not in refs:
            refs[req] = pipeline.run(net, [torch.from_numpy(f).to(dev) for f in pool[req]], cfg,
                                     traffic["post"], fixed, head_logits=reference.head_logits)
        judge.judge(out, refs[req], traffic["post"], float(limits["iou_slack"]), dev, tally)
    worst = tally.numbers()
    checks = judge.verdict(worst, limits)
    correct = failed_judged == 0 and all(c[3] for c in checks)
    result = {
        "correct": bool(correct),
        "attempted": len(records),
        "failed": sum(1 for r in records if not r.ok),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in checks}
    result["_judged"] = {"calls": len(picks), "failed": failed_judged, "bias_shift": shift,
                         "numbers": worst, "frames": tally.frames}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    pin_host()

    from portbench.spec import Benchmark

    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control))
    from portbench.program import forbidden_modules

    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    judged = result.pop("_judged")
    print(json.dumps(result))
    print(f"judged calls {judged['calls']}, failed among them {judged['failed']}, "
          f"head bias shift {judged['bias_shift']}; every number: {judged['numbers']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"{name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
