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
