"""The serving kernels as dispatcher ops (``yolort_tpu_torch/ops/library.py``)
and their C++ twin (``yolort_tpu_torch/csrc/torch_ops.cpp``).

- Each of the six ops passes ``torch.library.opcheck`` on CPU inputs
  (schema, fake implementation against the real one, dispatch under
  AOT autograd with static and dynamic shapes).
- On the CPU each op, its Python wrapper and its plain version
  (``*_reference``) give the same bits: the CPU implementation is the plain
  version, and the wrapper only checks and calls the op.
- The schemas in ``torch_ops.cpp``'s ``m.def`` strings parse to the
  registered ones; its constants equal the Python plans' constants; the
  Python launch plans at the main path's shapes equal a table written from
  the C++ plans (``bisect_plan``, ``row_fetch_geometry``; the stage-1 plan
  is the kernels' own C function on both sides, checked on the card).
- The kernel layer's imports point one way: no module of ``ops/cuda/``
  imports the postprocess, the models or the utilities, and
  ``ops/library.py`` imports nothing of ``ops/cuda/``; each op is
  registered once, by its own kernel module, with a CUDA implementation
  defined there that launches through ``_build.launch``.
- On the card (``cuda`` marker: ``python -m pytest --noconftest
  tests/test_torch_ops_library.py -m cuda``) each op launches its kernel
  once a call and equals the plain version bit for bit.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolort_tpu_torch.ops import library
from yolort_tpu_torch.ops.cuda import (
    bisect_count, bisect_count_reference, fused_cells_stage1, fused_cells_stage1_reference,
    lookup_fetch, lookup_fetch_reference, nms_mask, nms_mask_reference, reset_launch_counts,
    row_fetch, row_fetch_reference, select_extract, select_extract_reference,
)
from yolort_tpu_torch.ops.cuda import lookup_kernel, stage1_kernel
from yolort_tpu_torch.ops.cuda.lookup_kernel import bisect_plan, row_fetch_geometry
from yolort_tpu_torch.ops.select import f32_bits

CPP = Path(library.__file__).resolve().parents[1] / "csrc" / "torch_ops.cpp"
OPS_DIR = Path(library.__file__).resolve().parent
KERNEL_LAYER = sorted(f"cuda/{p.name}" for p in (OPS_DIR / "cuda").glob("*.py")) + ["library.py"]
# each op's kernel module, which registers it
OP_MODULES = {"fused_cells_stage1": "stage1_kernel", "bisect_count": "lookup_kernel",
              "row_fetch": "lookup_kernel", "lookup_fetch": "lookup_kernel",
              "select_extract": "lookup_kernel", "nms_mask": "nms_kernel"}
THR = f32_bits(0.25)


def _table(rng, bsz, m):
    a = rng.standard_normal((bsz, m * 128)) * 2 - 1
    return torch.from_numpy((1 / (1 + np.exp(-a))).astype(np.float32).reshape(bsz, m, 128))


def _boxes(rng, bsz, k):
    cxy = rng.uniform(0, 100, (bsz, k, 2))
    wh = rng.uniform(5, 40, (bsz, k, 2))
    return torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32))


def cases(device="cpu"):
    """{op name: (wrapper, plain version, args)} on small seeded inputs."""
    rng = np.random.default_rng(0)
    levels = [torch.from_numpy(rng.standard_normal((2, h, h, 27)).astype(np.float32))
              for h in (4, 2)]
    table = _table(rng, 2, 3)
    k = 50
    t, gt, eq = bisect_count_reference(table, k, THR)
    cnt = torch.cat([gt, eq], 1)
    off = (cnt.cumsum(1) - cnt).to(torch.int32)
    _, phys, p, is_eq = lookup_fetch_reference(table, off, k)
    idx = torch.from_numpy(rng.integers(-2, 5, (2, 7)).astype(np.int32))
    valid = torch.from_numpy(rng.random((2, 40)) < 0.8)
    out = {
        "fused_cells_stage1": (fused_cells_stage1, fused_cells_stage1_reference, (levels, 3, 9)),
        "bisect_count": (bisect_count, bisect_count_reference, (table, k, THR)),
        "row_fetch": (row_fetch, row_fetch_reference, (table, idx)),
        "lookup_fetch": (lookup_fetch, lookup_fetch_reference, (table, off, k)),
        "select_extract": (select_extract, select_extract_reference,
                           (table, phys, p, is_eq, t, THR)),
        "nms_mask": (nms_mask, nms_mask_reference, (_boxes(rng, 2, 40), valid, 0.45, 16, 10)),
    }
    return {name: (w, r, _to(args, device)) for name, (w, r, args) in out.items()}


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
                                    for x, y in zip(a, b))


def test_every_serving_op_is_registered_with_its_schema():
    assert set(library.SCHEMAS) == set(cases())
    for name, schema in library.SCHEMAS.items():
        assert str(library.op(name)._schema) == f"{library.NAMESPACE}::{schema}"


@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_opcheck(name):
    _, _, args = cases()[name]
    torch.library.opcheck(library.op(name), args)


@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_op_wrapper_and_plain_version_agree_bit_for_bit(name):
    wrapper, plain, args = cases()[name]
    reset_launch_counts()
    want = plain(*args)
    assert _same(library.op(name)(*args), want)
    assert _same(wrapper(*args), want)
    assert wrapper.launches == 0  # the CPU takes the plain version


def test_bfloat16_stage1_and_row_fetch_ops_match_the_plain_versions():
    rng = np.random.default_rng(1)
    levels = [torch.from_numpy(rng.standard_normal((1, 3, 5, 18)).astype(np.float32)).bfloat16()]
    assert _same(library.op("fused_cells_stage1")(levels, 2, 9),
                 fused_cells_stage1_reference(levels, 2, 9))
    table = levels[0].reshape(1, 15, 18)
    idx = torch.from_numpy(rng.integers(0, 15, (1, 6)).astype(np.int32))
    assert _same(library.op("row_fetch")(table, idx), row_fetch_reference(table, idx))


def test_cpp_schemas_parse_to_the_registered_ones():
    defs = re.findall(r'm\.def\("([^"]+)"\)', CPP.read_text())
    assert len(defs) == len(library.SCHEMAS)
    parsed = {s.split("(", 1)[0]: torch._C.parse_schema(f"{library.NAMESPACE}::{s}") for s in defs}
    assert set(parsed) == set(library.SCHEMAS)
    for name, schema in parsed.items():
        assert schema == library.op(name)._schema, name
    impls = set(re.findall(r'm\.impl\("(\w+)"', CPP.read_text()))
    assert impls == set(library.SCHEMAS)


def _imports(path: Path) -> set:
    """Every module an import statement of ``path`` names, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


@pytest.mark.parametrize("module", KERNEL_LAYER)
def test_kernel_layer_imports_point_down(module):
    names = _imports(OPS_DIR / module)
    above = ("ops.select", "ops.nms", "models", "utils")
    assert not [n for n in names if n.startswith(tuple(f"yolort_tpu_torch.{a}" for a in above))]
    if module == "library.py":
        assert not [n for n in names if n.startswith("yolort_tpu_torch.ops.cuda")]


def _register_calls(path: Path) -> list:
    """(op name, the CUDA implementation's name) of each ``register`` call
    in ``path``."""
    return [(c.args[0].value, getattr(c.args[2], "id", None))
            for c in ast.walk(ast.parse(path.read_text()))
            if isinstance(c, ast.Call) and getattr(c.func, "id", getattr(c.func, "attr", None))
            == "register" and c.args and isinstance(c.args[0], ast.Constant)]


@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_each_op_is_registered_by_its_kernel_module(name):
    """The one ``register("<op>", cpu, cuda, fake, wrapper)`` call is in
    the op's kernel module, and its CUDA implementation is a function of
    that module that launches through ``_build.launch``."""
    home = OPS_DIR / "cuda" / f"{OP_MODULES[name]}.py"
    calls = [(p, cuda) for p in OPS_DIR.parent.rglob("*.py")
             for op_name, cuda in _register_calls(p) if op_name == name]
    assert [p for p, _ in calls] == [home]
    cuda = [f for f in ast.parse(home.read_text()).body
            if isinstance(f, ast.FunctionDef) and f.name == calls[0][1]]
    assert len(cuda) == 1
    assert any(isinstance(c, ast.Call) and ast.unparse(c.func) == "_build.launch"
               for c in ast.walk(cuda[0]))


def _cpp_constants() -> dict:
    out = {}
    for name, expr in re.findall(r"constexpr \w+ (k\w+) = ([^;]+);", CPP.read_text()):
        out[name] = eval(re.sub(r"(\d)f\b", r"\1", expr.replace("kChunk", str(out.get("kChunk")))))
    return out


def test_cpp_plan_constants_equal_the_python_ones():
    c = _cpp_constants()
    assert c["kChunk"] == lookup_kernel.CHUNK
    assert c["kNoValidBits"] == lookup_kernel.NO_VALID_BITS
    assert c["kBisectSmemBytes"] == lookup_kernel.BISECT_SMEM_BYTES
    assert c["kRowBytes"] == lookup_kernel.ROW_BYTES
    assert c["kFetchWarpsPerBlock"] == lookup_kernel.FETCH_WARPS_PER_BLOCK
    assert c["kFetchSmallSlots"] == lookup_kernel.FETCH_SMALL_SLOTS
    assert c["kMaxLevels"] == stage1_kernel.MAX_LEVELS
    assert c["kNegLogit"] == stage1_kernel.NEG_LOGIT


# the C++ plans (torch_ops.cpp bisect_plan / row_fetch_geometry) at the
# main path's shapes: yolov5s @640 stage 1 (197 rows), stage 2 serving
# (325) and eval (2565), yolov5s6 @1280 stage 1 (797) and the streamed
# (5000); batch 1, 8 and 32
BISECT_TABLE = {(1, 197): (8, True), (8, 197): (8, True), (32, 197): (8, True),
                (8, 325): (8, True), (1, 2565): (16, True), (8, 2565): (16, True),
                (8, 797): (16, True), (8, 5000): (16, False), (8, 3): (3, True), (8, 1): (2, True)}
FETCH_TABLE = {(512, 1, 512): (4, 2), (512, 8, 512): (4, 4), (512, 1, 4096): (4, 4),
               (512, 8, 4096): (4, 4), (510, 8, 4104): (4, 2), (1020, 32, 4104): (4, 2)}


def test_python_plans_equal_the_cpp_table():
    for (bsz, m), want in BISECT_TABLE.items():
        assert tuple(bisect_plan(bsz, m)) == want, (bsz, m)
    for shape, want in FETCH_TABLE.items():
        assert row_fetch_geometry(*shape) == want, shape


def test_ops_are_traced_as_calls():
    """An exported graph holds each op as one call (no kernel traced
    through): the fake implementations give the shapes."""

    class Two(torch.nn.Module):
        def forward(self, table, idx, boxes, valid):
            t, gt, eq = bisect_count(table, 50, THR)
            return row_fetch(table, idx), nms_mask(boxes, valid, 0.45, 16, 10), t, gt, eq

    c = cases()
    args = (c["row_fetch"][2][0], c["row_fetch"][2][1], *c["nms_mask"][2][:2])
    ep = torch.export.export(Two(), args)
    text = str(ep.graph)
    for name in ("bisect_count", "row_fetch", "nms_mask"):
        assert f"yolort_tpu.{name}.default" in text
    assert all(_same(a, b) for a, b in zip(ep.module()(*args), Two()(*args)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_ops_launch_their_kernels_on_the_card(cuda_device, name):
    wrapper, plain, args = cases(cuda_device)[name]
    want = plain(*_to(args, "cpu"))
    reset_launch_counts()
    got = library.op(name)(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    assert _same(got, want)
    torch.library.opcheck(library.op(name), args, test_utils=("test_schema", "test_faketensor"))


# the stage-1 plan (rows a tile, stages, bytes a stage, dynamic shared
# memory, grid) for yolov5s's 255-value rows, as the C++ op library's
# yt_ops_plans printed it on an NVIDIA H100 80GB HBM3 (132 SMs)
STAGE1_TABLE = {torch.float32: (16, 4, 16336, 65472, 396),
                torch.bfloat16: (32, 4, 16336, 65472, 396)}


@pytest.mark.cuda
def test_stage1_plan_on_the_card_equals_the_cpp_table(cuda_device):
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count != 132:
        pytest.skip("the table is an H100 SXM's (132 SMs)")
    for dtype, want in STAGE1_TABLE.items():
        assert tuple(stage1_kernel.stage1_plan(255, dtype)) == want
