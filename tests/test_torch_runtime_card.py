"""The runtime on the card (``cuda`` marker; skips without one), JAX-free:

    python -m pytest --noconftest tests/test_torch_runtime_card.py -m cuda

- an ``export_aot`` artifact exported on the card serves there on every
  ``row_gather`` route, equal to the live pipeline, with the kernels'
  exact launches (fused_cells_stage1 1, bisect_count 2, the route's fetch
  kernel 1, nms_mask 1);
- an AOTInductor package pairs with the eager run detection by detection
  (Inductor fuses the network's elementwise work: no bit equality);
- ``StreamingPipeline`` on the card (pinned staging, copy stream) gives
  ``YOLOv5.__call__``'s detections on the same padded batches, float and
  int8;
- ``load_aot(path, device=...)`` moves an artifact between the card and
  the CPU.
The C++ driver's gate is tests/test_torch_cpp_driver.py.
"""

import numpy as np
import pytest
import torch

from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.models.yolov5 import YOLOv5
from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from yolort_tpu_torch.runtime.aot import _pipeline_fn, export_aot, export_aoti_package, load_aot, plan_for
from yolort_tpu_torch.runtime.streaming import StreamingPipeline

HW = (640, 640)
BATCH = 2
ROUTES = ("pallas_bisect", "pallas_lookup", "pallas_full")
FETCH = {"pallas_bisect": "row_fetch", "pallas_lookup": "lookup_fetch",
         "pallas_full": "select_extract"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def frames(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *HW, 3), dtype=np.uint8)


def card_model(device, dtype=torch.float32):
    """yolov5n-sized, seeded, head biases raised so that every frame has
    candidates above the serving threshold."""
    m = YOLO(0.33, 0.25, device=device, dtype=dtype, score_thresh=0.25, pre_nms_topk=512)
    with torch.no_grad():
        for conv in m.head.children():
            conv.bias.view(m.num_anchors, -1)[:, 4:] += 7.0
    return m


def as_dicts(outs, n_images):
    boxes, scores, labels, num = (t.cpu() for t in outs)
    return [{"boxes": boxes[i, :int(num[i])].float().numpy(),
             "scores": scores[i, :int(num[i])].float().numpy(),
             "labels": labels[i, :int(num[i])].numpy().astype(np.int64)} for i in range(n_images)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_exported_on_the_card_serves_there_through_the_kernels(cuda_device, tmp_path, route):
    m = card_model(cuda_device)
    m.row_gather = route
    pred = load_aot(export_aot(m, str(tmp_path / "card.ytpt"), batch_size=BATCH, input_hw=HW))
    assert pred.meta["device"].startswith("cuda")
    raw = frames(5, BATCH)
    reset_launch_counts()
    got = pred(raw)
    torch.cuda.synchronize()
    want = {"fused_cells_stage1": 1, "bisect_count": 2, FETCH[route]: 1, "nms_mask": 1}
    assert {fn.__name__: fn.launches for fn in KERNELS if fn.launches} == want
    with torch.no_grad():
        live = _pipeline_fn(m, plan_for(HW), torch.float32)(torch.from_numpy(raw).cuda())
    assert all(torch.equal(a, b) for a, b in zip(got, live))
    assert int(live[3].min()) > 0


@pytest.mark.cuda
def test_aoti_package_on_the_card_pairs_with_the_eager_run(cuda_device, tmp_path):
    m = card_model(cuda_device)
    runner = torch._inductor.aoti_load_package(
        export_aoti_package(m, str(tmp_path / "card.pt2"), batch_size=BATCH, input_hw=HW))
    raw = torch.from_numpy(frames(6, BATCH)).cuda()
    with torch.no_grad():
        got = as_dicts(runner(raw), BATCH)
        live = as_dicts(_pipeline_fn(m, plan_for(HW), torch.float32)(raw), BATCH)
    for g, w in zip(got, live):
        assert len(w["scores"]) > 0 and len(g["scores"]) == len(w["scores"])
        used = np.zeros(len(g["scores"]), bool)
        for box, score, lab in zip(w["boxes"], w["scores"], w["labels"]):
            ok = ((g["labels"] == lab) & ~used & np.isclose(g["scores"], score, rtol=1e-5, atol=0)
                  & (np.abs(g["boxes"] - box).max(-1) <= 1e-2))
            assert ok.any()
            used[np.flatnonzero(ok)[0]] = True


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_on_the_card_equals_yolov5_call(cuda_device, dtype):
    m = card_model(cuda_device, dtype)
    pipe = StreamingPipeline(m, batch_size=4, input_hw=HW, dtype=dtype)
    fr = list(frames(7, 10))
    outs = list(pipe.run(iter(fr)))
    assert len(outs) == 10
    served = YOLOv5(model=m, dtype=dtype, size=HW)
    for start in range(0, 10, 4):
        chunk = fr[start:start + 4]
        want = served(chunk + [chunk[-1]] * (4 - len(chunk)))
        for got, w in zip(outs[start:start + 4], want):
            for key in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(got[key], w[key])


@pytest.mark.cuda
def test_an_artifact_moves_between_the_card_and_the_cpu(cuda_device, tmp_path):
    """``load_aot(path, device=...)``: exported on the card and served on the
    CPU, the CPU export's output bit for bit; exported on the CPU and
    served on the card, exactly the route's kernel launches, and the card
    export's detections."""
    import copy

    m = card_model(cuda_device)
    on_card = export_aot(m, str(tmp_path / "card.ytpt"), batch_size=BATCH, input_hw=HW)
    on_cpu = export_aot(copy.deepcopy(m).cpu(), str(tmp_path / "cpu.ytpt"), batch_size=BATCH,
                        input_hw=HW)
    raw = frames(8, BATCH)
    got = load_aot(on_card, device="cpu")(raw)
    want = load_aot(on_cpu)(raw)
    assert got[0].device.type == "cpu" and int(want[3].min()) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    moved = load_aot(on_cpu, device="cuda")
    reset_launch_counts()
    out = moved(raw)
    torch.cuda.synchronize()
    assert {fn.__name__: fn.launches for fn in KERNELS if fn.launches} == {
        "fused_cells_stage1": 1, "bisect_count": 2, "row_fetch": 1, "nms_mask": 1}
    card_out = load_aot(on_card)(raw)
    for g, w in zip(as_dicts(out, BATCH), as_dicts(card_out, BATCH)):
        assert len(g["scores"]) == len(w["scores"]) > 0
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_an_int8_stream_on_the_card_equals_yolov5_call(cuda_device):
    """An int8-quantized model streams on the card (pinned staging, copy
    stream) with the qconv kernels, each frame equal to ``YOLOv5.__call__``
    on the same padded batch."""
    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    m = card_model(cuda_device)
    canvas = torch.from_numpy(frames(9, 2)).to(cuda_device).float() / 255.0
    q = quantize_compute_params(calibrate_activations(m, [canvas]))
    finalize_scales(q, canvas[:1])
    pipe = StreamingPipeline(q, batch_size=4, input_hw=HW, dtype=torch.float32)
    fr = list(frames(10, 6))
    reset_launch_counts()
    outs = list(pipe.run(iter(fr)))
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    assert counts["qconv1x1"] > 0 and counts["qconv_kxk"] > 0 and counts["nms_mask"] == 2
    served = YOLOv5(model=q, size=HW)
    for start in range(0, 6, 4):
        chunk = fr[start:start + 4]
        want = served(chunk + [chunk[-1]] * (4 - len(chunk)))
        for got, w in zip(outs[start:start + 4], want):
            for key in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(got[key], w[key])
