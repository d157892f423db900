"""A small cell added as files alone, for the CPU tests: a copy of the
benchmark's files with a configuration, a mix and limits of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_CELL = "tiny-cpu"


def _card_present() -> bool:
    return torch.cuda.is_available()


@pytest.fixture
def card():
    """Skips a test marked ``cuda`` where torch sees no card (decided
    here, when the test runs, not while the module is imported)."""
    if not _card_present():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path, like: str = "s640-eval-b32", own_limits: bool = False) -> Path:
    """A checkout-like directory: BENCHMARK.json and portbench/ copied, and
    the cell ``tiny-cpu`` added by new files and entries only: the cell
    ``like`` at a CPU test's size (its configuration's dtype, levels and
    anchors at a quarter of the width, 6 classes, a 96 or 128 canvas; its
    mix's load kind and thresholds on 2 frames a call), judged by limits
    of its own or, with ``own_limits``, by ``like``'s."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(w for w in doc["workloads"] if w["name"] == like)
    conf = next(c for c in doc["configs"] if c["name"] == entry["config"])
    cfg = json.loads((REPO / conf["file"]).read_text())
    side = 128 if cfg["p6"] else 96
    cfg.update(name="tiny-cfg", width_multiple=0.25, nc=6, size=[side, side],
               reduced=["width_multiple", "nc", "size"])
    (root / "portbench/configs/tiny-cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "portbench/traffic" / f"{entry['traffic']}.json").read_text())
    traffic.update(batch=2, sizes=[[72, side]], pool=2, judged_calls=2)
    traffic["post"] = dict(traffic["post"], pre_nms_topk=min(256, traffic["post"]["pre_nms_topk"]),
                           detections_per_img=40)
    (root / "portbench/traffic/tiny-mix.json").write_text(json.dumps(traffic))
    limits = (REPO / "portbench/limits" / f"{like}.json").read_text() if own_limits else json.dumps({
        "iou_slack": 0.02, "score_err": 1e-4, "box_err": 0.001, "miss_gap": 1e-4, "lost_frames": 0})
    (root / "portbench/limits/tiny-cpu.json").write_text(limits)
    doc["configs"].append({"name": "tiny-cfg", "source": "test", "file": "portbench/configs/tiny-cfg.json",
                           "reduced": ["width_multiple", "nc", "size"], "why": "CPU test"})
    doc["workloads"].append({"name": TINY_CELL, "config": "tiny-cfg", "traffic": "tiny-mix",
                             "chips": 1, "why": "CPU test"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root
