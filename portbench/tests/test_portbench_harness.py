"""The harness on the CPU: the benchmark as data, a cell added by files
alone and run as far as a run goes without a card, the result line, the
metric arithmetic, the faults that ``correct`` has to catch, and the
modules a run loads."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import run as run_mod
from portbench.spec import REFERENCE_API, Benchmark, Metric, SpecError

from conftest import REPO, TINY_CELL, make_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_keeps_the_contract():
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert doc["paths"] == ["portbench"] and 1 <= doc["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in doc["command"])
    names = [c["name"] for c in doc["configs"]] + [w["name"] for w in doc["workloads"]]
    names += [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in doc["workloads"]}
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in doc["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in doc["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        # every cell that reports a layer metric reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []


def test_every_cell_finds_its_files_by_name():
    bench = Benchmark(REPO)
    for w in bench.doc["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(bench.load_kind(cell.traffic), "window")
        assert (bench.dir / "limits" / f"{cell.name}.json").is_file()
        ref = bench.reference(cell.config)
        assert ref.__file__.endswith("reference/r60.py")
        assert all(callable(getattr(ref, fn)) for fn in REFERENCE_API)
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics_of(cell.name, kind):
                assert hasattr(bench.reader(m), "read"), m.name
    for op in ("fused_cells_stage1", "bisect_count", "row_fetch", "nms_mask"):
        assert (bench.dir / "bounds" / f"{op}.py").is_file()


def _tiny(root, **kw):
    bench = Benchmark(root, root / "portbench")
    return run_mod.run_cell(bench, bench.cell(TINY_CELL), 2 ** 33 + 11, 0.6, kw.pop("trace", False),
                            device="cpu", **kw)


def test_a_cell_added_as_files_alone_runs(tiny_root):
    res = _tiny(tiny_root)
    judged = res.pop("_judged")
    assert list(res) == RESULT_KEYS + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    assert res["device"]["platform"] == "cpu" and judged["calls"] >= 2
    assert set(res["checks"]) == {"score_err", "box_err", "miss_gap", "lost_frames"}


OWN_REFERENCE = '''"""The r6.0 layouts through the reference network's contract."""
from portbench.reference import models


def build(cfg):
    return models.build(cfg["p6"], cfg["nc"], cfg["depth_multiple"], cfg["width_multiple"],
                        cfg["anchors"])


head_logits = models.head_logits


def save_checkpoint(net, path):
    models.save_checkpoint(net, path)
'''


def _name_reference(root, name):
    path = root / "portbench/configs/tiny-cfg.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), reference=name)))


def test_a_cell_with_its_own_reference_runs_as_files_alone(tmp_path, monkeypatch):
    """The tiny cell, its configuration naming ``reference/tiny_r60.py``
    (a file added beside the others): built, seeded, checkpointed,
    FLOP-counted and judged through that file, with the numbers of the
    same cell without the key.  One request in the pool, and the judged
    calls fixed to the first two, so both runs judge the same frames
    whatever the window's length."""
    root = make_tiny_root(tmp_path)
    mix = root / "portbench/traffic/tiny-mix.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), pool=1)))
    (root / "portbench/reference/tiny_r60.py").write_text(OWN_REFERENCE)
    monkeypatch.setattr(run_mod, "_sample", lambda records, n, seed: [0, 1])
    plain = _tiny(root)
    _name_reference(root, "tiny_r60")
    bench = Benchmark(root, root / "portbench")
    assert bench.reference(bench.cell(TINY_CELL).config).__file__.endswith("reference/tiny_r60.py")
    own = _tiny(root)
    assert plain["correct"] is True and own["correct"] is True and own["failed"] == 0
    assert plain["attempted"] >= 2 and own["attempted"] >= 2
    assert own["checks"] == plain["checks"]
    a, b = plain.pop("_judged"), own.pop("_judged")
    assert a["calls"] == b["calls"] == 2 and a["bias_shift"] == b["bias_shift"]
    assert a["frames"] == b["frames"] and a["numbers"] == b["numbers"]


@pytest.mark.parametrize("case", ["unknown", "no-name", "incomplete", "support"])
def test_a_reference_that_cannot_be_resolved_stops_before_any_frame(tmp_path, monkeypatch, case):
    root = make_tiny_root(tmp_path)
    name, why = {"unknown": ("no_such_net", "missing file"), "no-name": ("../models", "no name"),
                 "incomplete": ("half_r60", "lacks save_checkpoint"),
                 "support": ("models", "no reference network")}[case]
    (root / "portbench/reference/half_r60.py").write_text(
        OWN_REFERENCE.split("def save_checkpoint")[0])
    _name_reference(root, name)
    from portbench import frames

    def no_frames(*a, **kw):
        raise AssertionError("frames made before the reference was resolved")
    monkeypatch.setattr(frames, "make_pool", no_frames)
    with pytest.raises(SpecError, match=why):
        _tiny(root)


def test_a_traced_run_reports_layers_and_breakdown(tiny_root):
    res = _tiny(tiny_root, trace=True)
    res.pop("_judged")
    assert list(res) == RESULT_KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    # no device here: the device-trace layer metrics find nothing and are left out
    assert res["metrics"] == {} and res["correct"] is True


def _shift_first_box(out):
    out = [dict(o) for o in out]
    for o in out:
        if len(o["boxes"]):
            o["boxes"] = o["boxes"].copy()
            o["boxes"][0] += 0.1 * max(1.0, float(np.ptp(o["boxes"][0])))
    return out


def _relabel_first(out):
    out = [dict(o) for o in out]
    for o in out:
        if len(o["labels"]):
            o["labels"] = o["labels"].copy()
            o["labels"][0] ^= 1  # a neighbouring class (every configuration has an even count)
    return out


def _drop_half(out):
    empty = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
             "labels": np.zeros(0, np.int64)}
    return [o if i % 2 == 0 else empty for i, o in enumerate(out)]


def _drop_top(out):
    return [{k: v[1:] for k, v in o.items()} for o in out]


def _wrong_slot(out):
    """The last frame of each call gets the first frame's answer."""
    return list(out[:-1]) + [out[0]]


FAULTS = [_shift_first_box, _relabel_first, _drop_half, _drop_top, _wrong_slot]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _break(fault):
    return lambda m: (lambda frames: fault(m(frames)))


@pytest.mark.parametrize("like", CELLS)
def test_each_cells_limits_pass_a_sound_run(tmp_path, like):
    """Each cell at a CPU test's size, judged by the cell's own limits."""
    res = _tiny(make_tiny_root(tmp_path, like, own_limits=True))
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, fault):
    """The timed path broken underneath: an answer altered where it is
    produced, half of the batch left out, a detection dropped, a frame
    given another slot's answer.  (A cell's own limits are held against
    the same faults at the cell's own size, on the card, below: at a
    test's size a shifted box or another slot's answer reads smaller.)"""
    res = _tiny(tiny_root, program_hook=_break(fault))
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_fails_each_cell_at_its_size(card, cell, fault):
    """The same faults in each cell as it is committed, at its own size on
    the card, judged by its own limits."""
    bench = Benchmark(REPO)
    res = run_mod.run_cell(bench, bench.cell(cell), 2 ** 33 + 17, 2.0, False,
                           program_hook=_break(fault))
    assert res["correct"] is False, res["checks"]


def test_a_failed_call_is_counted_and_not_correct(tiny_root):
    def hook(m):
        calls = []

        def call(frames):
            calls.append(1)
            if len(calls) > 3:  # after the warm-up
                raise RuntimeError("planted")
            return m(frames)
        return call
    res = _tiny(tiny_root, program_hook=hook)
    assert res["failed"] == res["attempted"] > 0 and res["correct"] is False


def _run_of(records, t0=0.0):
    return run_mod.Run(cell=None, t0=t0, records=records, flops_per_image=1.0, bounds=None,
                       setup_s=1.0, canvas=(64, 64))


@pytest.mark.parametrize("metric", ["images_per_s", "frames_per_s"])
def test_rates_cover_the_whole_window(metric):
    from portbench.spec import load_module

    rec = [run_mod.Record(0, 0.0, 1.0, 32, True, []), run_mod.Record(1, 1.0, 3.0, 32, True, []),
           run_mod.Record(2, 3.0, 4.0, 32, False, None)]
    read = load_module(REPO / f"portbench/e2e/{metric}.py").read
    # 64 images came back; the window runs to the last call's end, the failed one too
    assert read(_run_of(rec)) == pytest.approx(64 / 4.0)


def test_metric_reported_in():
    m = Metric("x", "ms", "lower", "host_clock", ["a"], "per_layer")
    assert m.reported_in("a") and not m.reported_in("b")
    assert Metric("y", "s", "lower", "host_clock", None, "end_to_end").reported_in("b")


def test_a_missing_card_fails_and_does_not_fall_back(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "s640-eval-b32", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_no_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, a run (past
    the look for a card) fails and prints no result."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path[:0] = ['.']; from portbench.run import run_cell, ROOT; "
            "from portbench.spec import Benchmark; b = Benchmark(ROOT); "
            "r = run_cell(b, b.cell('s640-eval-b32'), 1, 0.1, False, device='cpu'); print(r)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "yolort_tpu_torch" in proc.stderr


def test_loaded_modules(tiny_root):
    """A run loads no module whose top-level name is jax or yolort_tpu
    (compared whole: yolort_tpu_torch is the program); the reference loads
    nothing of the program."""
    code = f"""
import sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'portbench/tests')!r}]
import portbench.reference.models, portbench.reference.pipeline, portbench.reference.arith
import portbench.judge, portbench.weights, portbench.frames
ref_only = sorted({{n.split('.')[0] for n in sys.modules}})
from pathlib import Path
from portbench.spec import Benchmark
from portbench.run import run_cell
from portbench.program import forbidden_modules
root = Path({str(tiny_root)!r})
b = Benchmark(root, root / 'portbench')
run_cell(b, b.cell('tiny-cpu'), 3, 0.3, False, device='cpu')
print(repr((ref_only, forbidden_modules(sys.modules), 'yolort_tpu_torch' in sys.modules)))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_only, forbidden, port_loaded = eval(proc.stdout.strip().splitlines()[-1])
    assert "yolort_tpu_torch" not in ref_only and "yolort_tpu" not in ref_only and "jax" not in ref_only
    assert forbidden == [] and port_loaded


def test_forbidden_names_are_compared_whole():
    from portbench.program import forbidden_modules

    assert forbidden_modules(["yolort_tpu_torch", "yolort_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["yolort_tpu.models", "jax", "flax.linen"]) == ["flax.linen", "jax",
                                                                              "yolort_tpu.models"]


@pytest.mark.cuda
def test_controls_are_not_correct_on_the_card(tiny_root, card):
    """The configurations' controls, at the tiny cell's size on the card:
    the float32 program with TF32 on, and (bfloat16 configuration) the
    program's int8 path, both come out not correct."""
    bench = Benchmark(tiny_root, tiny_root / "portbench")
    cell = bench.cell(TINY_CELL)
    res = run_mod.run_cell(bench, cell, 7, 1.0, False, device="cuda", control=True)
    assert res["correct"] is False, res["checks"]
    res = run_mod.run_cell(bench, cell, 7, 1.0, False, device="cuda")
    assert res["correct"] is True, res["checks"]
