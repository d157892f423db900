"""One CUDA graph of a network's forward per input shape: ``GraphCache``.

yolov5s6's forward is some 200 small kernels, and launched one by one
the host takes longer than the card takes to run them.  A CUDA graph
launches them all at once (one ``cudaGraphLaunch``): the same kernels, in
the same order and precision, on the same stream, so a replay's outputs
are the eager forward's bit for bit.

``GraphCache.run(module, fn, x)`` runs ``fn(x)``, the module's plain
forward, and replays it as a graph only where all of this holds, read
from the call and the module alone:

- ``x`` is a plain tensor on a CUDA device;
- grad is off (``no_grad`` or ``inference_mode``) and ``module`` is not
  ``training``;
- nothing traces, exports or intercepts the call: no compiler, no
  ``torch.jit`` trace, no dispatch or function mode (fake tensors,
  ``FlopCounterMode``), no autocast, no capture already under way (all
  but the eval mode and the capture are ``eager_on_card``, which the float
  convs' fused epilogue in ``ops/blocks.py`` applies too);
- no layer of ``module`` sets ``EAGER_ONLY`` (a layer that records program
  spans or counters: a replay runs no Python), and no module has a forward
  hook (a replay calls none);
- the key (shape, strides, dtype, device, the backend flags that pick
  kernels, and whether ``inference_mode`` is on: a graph captured in it
  holds inference tensors, which no call outside it may write) was seen
  once before.  The first call of a key runs eagerly,
  which does cuDNN's and the allocator's lazy set-up; the second captures
  and replays; every later one replays.

At most ``MAX_GRAPHS`` graphs are kept a cache, each in a memory pool of
its own, the least recently used dropped first.  A graph reads the
weights where they lay when it was captured, so every call compares the
module's layers and where each parameter and buffer lies, and in what
dtype, with what they were (``_reads``), and drops the graphs where they
differ: a weight replaced (``param.data = ...``), ``.to()`` or ``.half()``
on the module or a child, a layer added or replaced.  An update in place
keeps them: a replay reads the new values.  What is not a tensor, such as
an int8 layer's activation scale, is read at the capture: set it before
the module runs on the card.

A graph's input and outputs are the same tensors at every replay, so a
caller that launches work on the outputs calls inside ``borrow()``, which
keeps the cache locked from the replay until that work is launched; a
call outside ``borrow()`` gets copies.  An eager call takes no lock.

Counters (``utils/profiling.py``): ``graph_replayed`` once a call (1 where
the outputs came from a replay, else 0), ``graph_captured`` once a
capture.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch
from torch.nn.modules import module as M
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from yolort_tpu_torch.utils.profiling import count

# graphs kept a cache: each holds a forward's activations in its own pool
MAX_GRAPHS = 4
REPLAYED, CAPTURED = "graph_replayed", "graph_captured"


def _backend_flags():
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())


def unintercepted(x) -> bool:
    """Grad off, and nothing tracing, exporting or intercepting a call on
    ``x``: no tensor subclass, compiler, ``torch.jit`` trace, dispatch or
    function mode (fake tensors, ``FlopCounterMode``), no CUDA autocast."""
    return (not torch.is_grad_enabled()
            and not (isinstance(x, torch.Tensor) and type(x) is not torch.Tensor)
            and not torch.compiler.is_compiling() and not torch.compiler.is_exporting()
            and not torch.jit.is_tracing() and not is_in_torch_dispatch_mode()
            and not torch._C._is_torch_function_mode_enabled()
            and not torch.is_autocast_enabled("cuda"))


def eager_on_card(x) -> bool:
    """``x`` on a CUDA device, ``unintercepted``: the part of the rule that
    the float convs' fused epilogue (``ops/blocks.py`` ``fused_epilogue``)
    shares."""
    return x.is_cuda and unintercepted(x)


def _call_engages(module, x) -> bool:
    """The rule's part that reads the call: ``eager_on_card``, the module in
    eval mode, no capture under way."""
    return (eager_on_card(x) and not module.training
            and not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()))


def _reads(module):
    """The rule's part that reads the layers, and what a graph of ``module``
    reads besides its input: each layer, and where each of its parameters
    and buffers lies and its dtype, as a list to compare; None where a layer
    sets ``EAGER_ONLY`` or a module or the process has a forward hook."""
    if M._global_forward_hooks or M._global_forward_pre_hooks:
        return None
    out, todo = [], [module]
    while todo:
        m = todo.pop()
        if m is None:
            continue
        if m._forward_hooks or m._forward_pre_hooks or getattr(type(m), "EAGER_ONLY", False):
            return None
        out.append(m)
        for t in (*m._parameters.values(), *m._buffers.values()):
            if t is not None:
                out += (t.data_ptr(), t.dtype)
        todo += m._modules.values()
    return out


class CudaGraph:
    """One captured forward: the graph, its input buffer and its outputs."""

    def __init__(self, fn, x: torch.Tensor) -> None:
        from yolort_tpu_torch.ops.cuda import KERNELS

        self.input = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
        self.input.copy_(x)
        self.graph = torch.cuda.CUDAGraph()
        before = [k.launches for k in KERNELS]
        # a side stream from torch's pool, as torch.cuda.graph takes by default,
        # but on x's device
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(x.device),
                              capture_error_mode="thread_local"):
            self.outputs = fn(self.input)
        # the wrappers of the hand-written kernels count their launches in
        # Python: a replay adds what the capture counted
        self._launches = [(k, k.launches - b) for k, b in zip(KERNELS, before) if k.launches != b]
        self._stream = torch.cuda.current_stream(x.device)
        self.graph.replay()  # the capture's counts stand for this first replay

    def replay(self, x: torch.Tensor) -> None:
        stream = torch.cuda.current_stream(x.device)
        if stream != self._stream:  # the last replay's readers were launched there
            stream.wait_stream(self._stream)
            self._stream = stream
        self.input.copy_(x)
        self.graph.replay()
        for k, n in self._launches:
            k.launches += n

    def release(self) -> None:
        """Wait for the work that may read the graph's memory, before its
        pool goes back to the allocator."""
        torch.cuda.synchronize(self.input.device)


class GraphCache:
    """The graphs of one module, by key (module docstring).  ``capture(fn,
    x)`` makes a graph (``CudaGraph`` on the card; tests pass a
    stand-in), an object with ``outputs``, ``replay(x)`` and ``release()``."""

    def __init__(self, capture=None) -> None:
        self._capture = capture or CudaGraph
        self._lock = threading.RLock()
        self._local = threading.local()
        self._seen = set()
        self._graphs: OrderedDict = OrderedDict()
        self._reads = None  # _reads(module) when the graphs were captured

    def __reduce__(self):
        return GraphCache, ()  # a copy or a pickle of a module starts empty

    def __len__(self) -> int:
        return len(self._graphs)

    @contextlib.contextmanager
    def borrow(self):
        """Inside the block ``run`` returns a graph's own outputs, and the
        cache stays locked from that replay to the block's end, so that no
        other call replays over them: launch every reader of them inside."""
        outer = getattr(self._local, "held", None)
        self._local.held = held = []
        try:
            yield
        finally:
            self._local.held = outer
            for _ in held:
                self._lock.release()

    def clear(self) -> None:
        """Drop every graph and every key seen."""
        with self._lock:
            for graph in self._graphs.values():
                graph.release()
            self._graphs.clear()
            self._seen.clear()
            self._reads = None

    def run(self, module, fn, x):
        """``fn(x)``, from a replay of its graph where the rule holds."""
        graph = self._replayed(module, fn, x) if _call_engages(module, x) else None
        if graph is None:
            count(REPLAYED, 0)
            return fn(x)
        count(REPLAYED, 1)
        held = getattr(self._local, "held", None)
        if held is not None:
            held.append(graph)  # the lock goes at the end of borrow()
            return graph.outputs
        try:
            return [o.clone() for o in graph.outputs]
        finally:
            self._lock.release()

    def _replayed(self, module, fn, x):
        """The graph of ``x``'s key, replayed on ``x`` (or captured on it), with
        the lock held; None, the lock free, where the call runs eagerly."""
        reads = _reads(module)
        if reads is None:
            return None
        key = (tuple(x.shape), x.stride(), x.dtype, x.device, _backend_flags(),
               torch.is_inference_mode_enabled())
        self._lock.acquire()
        try:
            if reads != self._reads:  # a weight moved or a layer changed
                self.clear()
                self._reads = reads
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
                graph.replay(x)
            elif key in self._seen:
                graph = self._new(fn, x, key)
            else:
                self._seen.add(key)
        except BaseException:
            self._lock.release()
            raise
        if graph is None:
            self._lock.release()
        return graph

    def _new(self, fn, x, key):
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)[1].release()
        graph = self._capture(fn, x)
        count(CAPTURED, 1)
        self._graphs[key] = graph
        return graph
