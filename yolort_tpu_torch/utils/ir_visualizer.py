"""Compiler-IR inspection and visualization.

Port of ``yolort_tpu/utils/ir_visualizer.py``.  The reference renders
TorchScript IR to graphviz (TorchScriptVisualizer,
yolort/relay/ir_visualizer.py:20); the JAX package dumps the jaxpr,
StableHLO and the optimized HLO.  Their counterparts here: the FX graph of
``torch.export`` (``get_graph``), the exported program's text
(``get_exported_text``), Inductor's generated code (``get_optimized_code``),
a FLOP and byte count (``cost_analysis``) and a graphviz dot of the FX
graph (``GraphVisualizer``).  Each takes a module and example inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def _export(fn: nn.Module, *example_args):
    with torch.no_grad():
        return torch.export.export(fn, tuple(example_args))


def get_graph(fn: nn.Module, *example_args) -> str:
    """The FX graph ``torch.export`` traces (the jaxpr's counterpart)."""
    return str(_export(fn, *example_args).graph)


def get_exported_text(fn: nn.Module, *example_args) -> str:
    """The exported program's text, what an export artifact ships (the
    StableHLO's counterpart)."""
    return str(_export(fn, *example_args))


def get_optimized_code(fn: nn.Module, *example_args) -> str:
    """The code Inductor generates for ``fn`` (the optimized HLO's
    counterpart): its fusion decisions, on the inputs' device."""
    from torch._inductor.utils import run_and_get_code

    compiled = torch.compile(fn, backend="inductor")
    with torch.no_grad():
        _, code = run_and_get_code(compiled, *example_args)
    return "\n".join(code)


class _ByteCounter(TorchDispatchMode):
    """Bytes of every op's tensor inputs and outputs, each counted once an op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves, _ = tree_flatten((args, kwargs, out))
        self.bytes += sum(t.numel() * t.element_size() for t in leaves
                          if isinstance(t, torch.Tensor))
        return out


def cost_analysis(fn: nn.Module, *example_args) -> dict:
    """{"flops", "bytes accessed"} of one call of ``fn`` on the example
    inputs (replaces the reference's thop profiler,
    v5/utils/torch_utils.py:101): FLOPs as ``FlopCounterMode`` counts them
    (convolutions and matmuls), bytes as the sizes of every op's inputs
    and outputs, counted under a ``TorchDispatchMode``."""
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with torch.no_grad(), flops, counter:
        fn(*example_args)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(counter.bytes)}


class GraphVisualizer:
    """Render an exported FX graph as graphviz dot: one node per call, the
    inputs and outputs coloured as ``JaxprVisualizer`` colours them."""

    def __init__(self, fn: nn.Module, *example_args):
        self.graph = _export(fn, *example_args).graph

    def to_dot(self, max_nodes: int = 400) -> str:
        lines = ["digraph fx {", "  rankdir=TB;", "  node [shape=box, fontsize=10];"]
        src = {}
        inputs = [n for n in self.graph.nodes if n.op == "placeholder"]
        calls = [n for n in self.graph.nodes if n.op in ("call_function", "call_method",
                                                           "call_module")]
        for i, node in enumerate(inputs):
            lines.append(f'  in{i} [label="input {i}: {node.name}", style=filled, '
                         f'fillcolor=lightblue];')
            src[node] = f"in{i}"
        for i, node in enumerate(calls[:max_nodes]):
            lines.append(f'  op{i} [label="{_label(node)}"];')
            for arg in node.all_input_nodes:
                if arg in src:
                    lines.append(f"  {src[arg]} -> op{i};")
            src[node] = f"op{i}"
        out = next(n for n in self.graph.nodes if n.op == "output")
        for i, arg in enumerate(_flat_nodes(out.args)):
            lines.append(f'  out{i} [label="output {i}", style=filled, fillcolor=lightgreen];')
            if arg in src:
                lines.append(f"  {src[arg]} -> out{i};")
        if len(calls) > max_nodes:
            lines.append(f'  truncated [label="... {len(calls) - max_nodes} more calls"];')
        lines.append("}")
        return "\n".join(lines)

    def save(self, path: str, max_nodes: int = 400) -> None:
        with open(path, "w") as f:
            f.write(self.to_dot(max_nodes))


def _label(node) -> str:
    """An op overload by its qualified name (``aten.convolution.default``,
    ``yolort_tpu.nms_mask.default``), any other callable by its name."""
    t = node.target
    name = str(t) if isinstance(t, torch._ops.OpOverload) else getattr(t, "__name__", str(t))
    return name.replace('"', '\\"')


def _flat_nodes(args) -> Tuple:
    leaves, _ = tree_flatten(args)
    return tuple(leaves)
