"""The port's kernel wrappers where there is no GPU: modules import without
nvcc, CPU tensors take the plain versions and launch nothing, any other
device raises, and a missing toolkit makes the build raise.

The kernel-against-plain cases carry the ``cuda`` marker and skip here;
on a machine with the card run them with
``python -m pytest tests/test_torch_kernels_cpu.py -m cuda``."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import yolort_tpu_torch
from yolort_tpu_torch.ops.cuda import (
    KERNELS, _build, bisect_count, bisect_count_reference, nms_mask, nms_mask_reference,
    qconv, qconv1x1, qconv1x1_reference, qconv_kxk, qconv_kxk_reference, reset_launch_counts,
    row_fetch, row_fetch_reference,
)
from yolort_tpu_torch.ops.cuda.qconv_kernel import pack_weight, padded_depth

PKG = Path(yolort_tpu_torch.__file__).parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device="cpu"):
    rng = np.random.default_rng(0)
    cxy = rng.uniform(0, 200, (2, 512, 2))
    wh = rng.uniform(5, 80, (2, 512, 2))
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)).to(device)
    valid = torch.arange(512, device=device)[None, :].expand(2, -1) < 400
    a = rng.standard_normal((2, 40 * 128)) * 2 - 1
    table = torch.from_numpy((1 / (1 + np.exp(-a))).astype(np.float32).reshape(2, 40, 128)).to(device)
    idx = torch.from_numpy(rng.integers(-3, 43, (2, 300)).astype(np.int32)).to(device)
    return boxes, valid.contiguous(), table, idx


def test_package_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|yolort_tpu)\b")
    offenders = [f"{p}:{i}" for p in PKG.rglob("*.py")
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pat.match(line)]
    assert not offenders
    code = ("import sys, yolort_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yolort_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=120)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    reset_launch_counts()
    boxes, valid, table, idx = _inputs()
    assert torch.equal(nms_mask(boxes, valid, 0.5, 256, 100), nms_mask_reference(boxes, valid, 0.5, 256, 100))
    for a, b in zip(bisect_count(table, 300, 0x3E800000), bisect_count_reference(table, 300, 0x3E800000)):
        assert torch.equal(a, b)
    assert torch.equal(row_fetch(table, idx), row_fetch_reference(table, idx))
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    assert not _build._loaded  # nothing was built or loaded


def test_other_devices_raise():
    boxes, valid, table, idx = (t.to("meta") for t in _inputs())
    with pytest.raises(ValueError, match="cuda or cpu"):
        nms_mask(boxes, valid, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bisect_count(table, 10, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        row_fetch(table, idx)


def test_wrappers_check_their_inputs():
    boxes, valid, table, idx = _inputs()
    with pytest.raises(ValueError):
        nms_mask(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        nms_mask(boxes, valid[:, :10], 0.5)
    with pytest.raises(ValueError):
        bisect_count(table[..., :64], 10, 0)
    with pytest.raises(ValueError):
        bisect_count(table, 0, 0)
    with pytest.raises(ValueError):
        bisect_count(table, 10, -1)
    with pytest.raises(ValueError):
        row_fetch(table.half(), idx)
    with pytest.raises(ValueError):
        row_fetch(table, idx[:1])


def test_build_names_library_by_source_hash(monkeypatch):
    path = _build.library_path()
    assert path.parent == PKG.parent / "build" / "yolort_tpu_torch"
    assert re.fullmatch(r"libyolort_kernels_[0-9a-f]{16}\.so", path.name)
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} == set(_build.SOURCES)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path


def test_build_without_toolkit_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build.build()
    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.cuda
def test_nms_mask_kernel_matches_plain(cuda_device):
    boxes, valid, _, _ = _inputs(cuda_device)
    for stop in (0, 100):
        got = nms_mask(boxes, valid, 0.5, 256, stop)
        assert torch.equal(got, nms_mask_reference(boxes, valid, 0.5, 256, stop))


@pytest.mark.cuda
def test_bisect_count_kernel_matches_plain(cuda_device):
    _, _, table, _ = _inputs(cuda_device)
    for k, thr in ((300, 0.25), (5000, 0.25), (10, 0.9999)):
        bits = int(np.float32(thr).view(np.int32))
        for a, b in zip(bisect_count(table, k, bits), bisect_count_reference(table, k, bits)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_vector_load_kernels_reject_misaligned_tensors(cuda_device):
    boxes, valid, table, _ = _inputs(cuda_device)
    # contiguous views that start one float past a 16-byte boundary
    shifted_boxes = boxes.flatten()[1:1 + 2 * 511 * 4].view(2, 511, 4)
    assert shifted_boxes.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        nms_mask(shifted_boxes, valid[:, :511].contiguous(), 0.5)
    shifted_table = table.flatten()[1:1 + 128].view(1, 1, 128)
    with pytest.raises(ValueError, match="aligned"):
        bisect_count(shifted_table, 10, 0)


@pytest.mark.cuda
def test_row_fetch_kernel_matches_plain(cuda_device):
    _, _, table, idx = _inputs(cuda_device)
    for tab in (table, table.to(torch.bfloat16), table[..., :85].contiguous().to(torch.bfloat16)):
        iv = torch.int32 if tab.dtype == torch.float32 else torch.int16
        assert torch.equal(row_fetch(tab, idx).view(iv), row_fetch_reference(tab, idx).view(iv))


def _qconv_operands(k, n, h, w, c, co, seed, device="cpu"):
    """Seeded int8 activations (channels_last), packed int8 weights, f32
    scale and bias."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c), dtype=np.int8))
    wq = pack_weight(rng.integers(-10, 11, (k, k, c, co), dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, (co,)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, (co,)).astype(np.float32))
    xq = xq.permute(0, 3, 1, 2)  # NHWC bytes seen as channels_last NCHW
    return tuple(t.to(device) for t in (xq, wq, scale, bias))


def test_pack_weight_layout():
    wq = np.random.default_rng(0).integers(-127, 128, (6, 6, 3, 5), dtype=np.int8)
    packed = pack_weight(wq)
    assert packed.shape == (5, padded_depth(6, 3)) == (5, 108)
    np.testing.assert_array_equal(packed.numpy()[2, :3], wq[0, 0, :, 2])
    np.testing.assert_array_equal(packed.numpy()[2, 3:6], wq[0, 1, :, 2])
    odd = pack_weight(wq[:3, :3, :, :])  # K = 27 -> padded to 28 with a zero
    assert odd.shape == (5, 28) and (odd[:, 27] == 0).all()


def test_qconv_cpu_tensors_take_the_plain_versions():
    reset_launch_counts()
    xq, wq, scale, bias = _qconv_operands(3, 1, 8, 10, 16, 32, seed=1)
    for fn, ref, kw in ((qconv1x1, qconv1x1_reference, {}),
                        (qconv_kxk, qconv_kxk_reference, dict(k=3))):
        w = wq[:, :16].contiguous() if fn is qconv1x1 else wq
        got = fn(xq, w, scale, bias, inv_out_scale=4.0, **kw)
        assert torch.equal(got, ref(xq, w, scale, bias, inv_out_scale=4.0, **kw))
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    assert not _build._loaded


def test_qconv_wrappers_check_their_inputs_and_refuse_groups():
    xq, wq, scale, bias = _qconv_operands(3, 1, 8, 10, 16, 32, seed=2)
    with pytest.raises(ValueError, match="groups"):
        qconv(xq, wq, scale, bias, k=3, groups=2)
    with pytest.raises(ValueError, match="wq"):
        qconv_kxk(xq, wq[:, :-4], scale, bias, k=3)
    with pytest.raises(ValueError, match="int8"):
        qconv_kxk(xq.float(), wq, scale, bias, k=3)
    with pytest.raises(ValueError, match="scale"):
        qconv_kxk(xq, wq, scale.double(), bias, k=3)
    with pytest.raises(ValueError, match="act"):
        qconv_kxk(xq, wq, scale, bias, k=3, act="relu")
    with pytest.raises(ValueError, match="out_dtype"):
        qconv_kxk(xq, wq, scale, bias, k=3, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        qconv_kxk(*(t.to("meta") for t in (xq, wq, scale, bias)), k=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        qconv1x1(*(t.to("meta") for t in (xq, wq[:, :16].contiguous(), scale, bias)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,pad,n,h,w,c,co", [
    (6, 2, 2, 2, 64, 96, 3, 32),
    (3, 2, 1, 2, 40, 48, 32, 64),
    (3, 1, 1, 2, 20, 24, 64, 64),
    (1, 1, 0, 2, 20, 24, 128, 96),
    (1, 1, 0, 1, 7, 9, 36, 255),
])
def test_qconv_kernels_match_plain(cuda_device, k, s, pad, n, h, w, c, co):
    args = _qconv_operands(k, n, h, w, c, co, seed=k + c, device=cuda_device)
    for act in ("silu", "none"):
        kw = dict(k=k, stride=s, pad=pad, act=act)
        want = qconv_kxk_reference(*args, inv_out_scale=6.0, **kw)
        got = qconv(*args, inv_out_scale=6.0, **kw)
        assert torch.equal(got, want)
        for dt in (torch.float32, torch.bfloat16):
            wantf = qconv_kxk_reference(*args, out_dtype=dt, **kw)
            gotf = qconv(*args, out_dtype=dt, **kw)
            assert gotf.dtype == dt and torch.equal(gotf, wantf)
