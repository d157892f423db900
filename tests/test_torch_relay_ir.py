"""The export surfaces (``yolort_tpu_torch/relay.py``) and the IR tools
(``yolort_tpu_torch/utils/ir_visualizer.py``) on the CPU.

- ``LogitsDecoder`` against the JAX package's on the same weights and
  images: rtol 1e-4 / atol 1e-5 (two frameworks' f32 convolutions through
  the network; the decode itself is the same arithmetic).
- ``get_trace_module``'s program text names the ``yolort_tpu`` ops (no
  kernel traced through); ``register_nms`` raises.
- ``GraphVisualizer.to_dot`` has the input, op, output and truncation
  nodes; ``cost_analysis`` has both keys, its FLOPs equal to
  ``FlopCounterMode``'s count; ``get_graph``, ``get_exported_text`` and
  ``get_optimized_code`` give the FX graph, the program and Inductor's code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from torch_parity import tiny_pair
from yolort_tpu.relay import LogitsDecoder as JaxLogitsDecoder
from yolort_tpu_torch.relay import LogitsDecoder, get_trace_module, register_nms
from yolort_tpu_torch.utils.ir_visualizer import (
    GraphVisualizer, cost_analysis, get_exported_text, get_graph, get_optimized_code,
)

HW = (64, 64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=2, head_shift=3.0, score_thresh=0.25, pre_nms_topk=256)


def test_logits_decoder_matches_jax(pair):
    jm, params, tm = pair
    x = np.random.default_rng(0).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    jb, js = JaxLogitsDecoder(jm)(params, jnp.asarray(x))
    with torch.no_grad():
        tb, ts = LogitsDecoder(tm)(torch.from_numpy(x))
    na = sum((HW[0] // s) * (HW[1] // s) for s in (8, 16, 32)) * 3
    assert tb.shape == (2, na, 4) and ts.shape == (2, na, 80)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    assert float((tb[..., 2] - tb[..., 0]).mean()) > 0  # xyxy


def test_trace_module_names_the_kernel_ops(pair):
    _, _, tm = pair
    module, ep = get_trace_module(tm, batch_size=1, input_hw=HW)
    text = str(ep)
    for op in ("fused_cells_stage1", "bisect_count", "row_fetch", "nms_mask"):
        assert f"torch.ops.yolort_tpu.{op}.default" in text
    raw = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, *HW, 3), np.uint8))
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(ep.module()(raw), module(raw)))
    with pytest.raises(NotImplementedError, match="export_aot"):
        register_nms()


class Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.lin = torch.nn.Linear(8, 4)

    def forward(self, x):
        y = torch.relu(self.conv(x)).mean((2, 3))
        return torch.sigmoid(self.lin(y))


def test_graph_visualizer_dot():
    x = torch.randn(2, 3, 8, 8)
    viz = GraphVisualizer(Small(), x)
    dot = viz.to_dot()
    assert dot.startswith("digraph fx {") and dot.endswith("}")
    assert 'label="input 0' in dot and 'label="output 0"' in dot
    assert "fillcolor=lightblue" in dot and "fillcolor=lightgreen" in dot
    assert "aten.conv2d.default" in dot or "aten.convolution.default" in dot
    assert "truncated" not in dot
    short = viz.to_dot(max_nodes=2)
    assert "truncated" in short and 'label="op2"' not in short and "op1 [" in short


def test_graph_visualizer_save(tmp_path):
    path = tmp_path / "g.dot"
    GraphVisualizer(Small(), torch.randn(1, 3, 8, 8)).save(str(path), max_nodes=3)
    assert path.read_text().startswith("digraph fx {")


def test_cost_analysis_counts_flops_and_bytes():
    m, x = Small(), torch.randn(2, 3, 8, 8)
    costs = cost_analysis(m, x)
    assert set(costs) == {"flops", "bytes accessed"}
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        m(x)
    assert costs["flops"] == fc.get_total_flops() > 0
    assert costs["bytes accessed"] > x.numel() * 4


def test_cost_analysis_of_the_pipeline(pair):
    _, _, tm = pair
    module, _ = get_trace_module(tm, batch_size=1, input_hw=HW)
    raw = torch.zeros(1, *HW, 3, dtype=torch.uint8)
    costs = cost_analysis(module, raw)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        module(raw)
    assert costs["flops"] == fc.get_total_flops() > 0 and costs["bytes accessed"] > 0


def test_graph_program_and_optimized_code():
    m, x = Small(), torch.randn(1, 3, 8, 8)
    assert "graph():" in get_graph(m, x)
    assert "ExportedProgram" in get_exported_text(m, x)
    code = get_optimized_code(m, x)
    assert "def call" in code or "kernel" in code
