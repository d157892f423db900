"""The streaming pipeline (``yolort_tpu_torch/runtime/streaming.py``) on the
CPU: 10 frames at batch 4 give 10 results (the tail batch padded, only its
real frames yielded), each equal to ``YOLOv5.__call__`` on the same padded
batch, and matching the JAX package's ``StreamingPipeline`` on the same
frames and weights at the JAX runtime tests' tolerance (boxes rtol 1e-3 /
atol 1e-4, scores rtol 1e-3 / atol 1e-5; head biases shifted so that the
candidates are no near-ties).  The card's path (pinned staging, copy
stream) is held against ``YOLOv5.__call__`` in
tests/test_torch_runtime_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxCellModel, assert_detections_match, tiny_pair
from yolort_tpu.runtime.streaming import StreamingPipeline as JaxStreamingPipeline
from yolort_tpu_torch.models.yolov5 import YOLOv5
from yolort_tpu_torch.runtime.streaming import StreamingPipeline

HW = (96, 96)
BATCH = 4
N = 10


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=5, head_shift=7.0, score_thresh=0.25, pre_nms_topk=512)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (*HW, 3), dtype=np.uint8) for _ in range(N)]


@pytest.fixture(scope="module")
def streamed(pair, frames):
    _, _, tm = pair
    pipe = StreamingPipeline(tm, batch_size=BATCH, input_hw=HW, dtype=torch.float32)
    pipe.warmup(1)
    return list(pipe.run(iter(frames)))


def test_every_frame_is_yielded_once(streamed):
    assert len(streamed) == N
    for o in streamed:
        assert set(o) == {"boxes", "scores", "labels"}
        assert o["boxes"].dtype == np.float32 and o["labels"].dtype == np.int64
        assert len(o["boxes"]) > 0


def test_streamed_detections_equal_the_live_model_on_the_padded_batches(pair, frames, streamed):
    _, _, tm = pair
    live = YOLOv5(model=tm, device="cpu", size=HW)
    for start in range(0, N, BATCH):
        chunk = frames[start:start + BATCH]
        want = live(chunk + [chunk[-1]] * (BATCH - len(chunk)))
        for got, w in zip(streamed[start:start + BATCH], want):
            for key in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(got[key], w[key])


def test_streamed_detections_match_the_jax_pipeline(pair, frames, streamed):
    jm, params, _ = pair
    pipe = JaxStreamingPipeline(JaxCellModel(jm), params, batch_size=BATCH, input_hw=HW,
                                dtype=jnp.float32)
    want = list(pipe.run(iter(frames)))
    assert len(want) == N
    for i, (g, w) in enumerate(zip(streamed, want)):
        assert_detections_match(g, w, f"frame {i}")


def test_a_frame_of_another_size_raises(pair):
    _, _, tm = pair
    pipe = StreamingPipeline(tm, batch_size=BATCH, input_hw=HW, dtype=torch.float32)
    with pytest.raises(ValueError, match="takes"):
        list(pipe.run([np.zeros((64, 96, 3), np.uint8)]))


# --- an int8-quantized model streams ------------------------------------

INT8_HW = (96, 128)


@pytest.fixture(scope="module")
def nano_int8():
    """yolov5n r6.0 through the JAX recipe (calibrate, quantize, finalize),
    its finalized leaves carried into a port YOLO: (JAX model, finalized
    tree, port model).  The head's float biases are raised by 7 after
    finalizing, in both trees, so that each frame has some 200 candidates
    above the serving threshold."""
    import jax

    from torch_parity import randomize_convs, shift_head_bias, unwrap_static
    from yolort_tpu.models.yolo import YOLO as JaxYOLO
    from yolort_tpu.ops import quantization as JQ
    from yolort_tpu_torch.models._bridge import params_from_jax
    from yolort_tpu_torch.models.yolo import YOLO

    cfg = dict(score_thresh=0.25, pre_nms_topk=512)
    jm = JaxYOLO(0.33, 0.25, **cfg)
    params = randomize_convs(jm.init(jax.random.PRNGKey(11)), 11)
    rng = np.random.default_rng(2)
    cal = [jnp.asarray(rng.random((2, *INT8_HW, 3)), jnp.float32) for _ in range(2)]
    pc = JQ.calibrate_activations(jm.head_outputs, params, cal)
    qp = JQ.finalize_scales(jm.head_outputs, JQ.quantize_compute_params(pc),
                            np.asarray(cal[0][:1]))
    qp = shift_head_bias(qp, 7.0)
    tm = YOLO(0.33, 0.25, device="cpu", **cfg)
    params_from_jax(unwrap_static(qp), tm)
    return jm, qp, tm


@pytest.fixture(scope="module")
def int8_frames():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, (*INT8_HW, 3), dtype=np.uint8) for _ in range(6)]


@pytest.fixture(scope="module")
def int8_streamed(nano_int8, int8_frames):
    _, _, tm = nano_int8
    pipe = StreamingPipeline(tm, batch_size=BATCH, input_hw=INT8_HW, dtype=torch.float32)
    return list(pipe.run(iter(int8_frames)))


def test_an_int8_model_streams_as_yolov5_call_serves_it(nano_int8, int8_frames, int8_streamed):
    """Bit-exact against ``YOLOv5.__call__`` on the same padded batches, in
    float32 compute (the model as it is) and in bfloat16 compute (a copy
    cast to bfloat16, whose int8 buffers stay as they are)."""
    import copy

    from yolort_tpu_torch.ops.blocks import _Int8Conv

    _, _, tm = nano_int8
    assert any(isinstance(m, _Int8Conv) and m.quantized for m in tm.modules())
    bf = copy.deepcopy(tm).to(torch.bfloat16)
    runs = {torch.float32: (tm, int8_streamed),
            torch.bfloat16: (bf, list(StreamingPipeline(
                tm, batch_size=BATCH, input_hw=INT8_HW, dtype=torch.bfloat16).run(
                    iter(int8_frames))))}
    for dtype, (model, streamed) in runs.items():
        assert len(streamed) == len(int8_frames)
        live = YOLOv5(model=model, device="cpu", size=INT8_HW, dtype=dtype)
        for start in range(0, len(int8_frames), BATCH):
            chunk = int8_frames[start:start + BATCH]
            want = live(chunk + [chunk[-1]] * (BATCH - len(chunk)))
            for got, w in zip(streamed[start:start + BATCH], want):
                assert len(w["scores"]) > 0, dtype
                for key in ("boxes", "scores", "labels"):
                    np.testing.assert_array_equal(got[key], w[key], err_msg=str(dtype))


def test_an_int8_stream_matches_the_jax_int8_stream(nano_int8, int8_frames, int8_streamed):
    """The JAX package's ``StreamingPipeline`` on the finalized tree, float32
    compute, at the JAX runtime tests' tolerance.  It runs op by op
    (``jax.disable_jit``), as tests/test_torch_quant.py holds the int8
    slice: jitted, XLA fuses the score's sigmoids, which moves the scores
    by up to 1e-5 relative, and of these frames' ~200 candidates near 0.86
    some near-tied overlapping pairs then swap their NMS order (frame 3
    kept 203 of the eager program's 206, which the port keeps too)."""
    import jax

    jm, qp, _ = nano_int8
    pipe = JaxStreamingPipeline(JaxCellModel(jm), qp, batch_size=BATCH, input_hw=INT8_HW,
                                dtype=jnp.float32)
    with jax.disable_jit():
        want = list(pipe.run(iter(int8_frames)))
    assert len(want) == len(int8_streamed)
    for i, (g, w) in enumerate(zip(int8_streamed, want)):
        assert_detections_match(g, w, f"int8 frame {i}")
