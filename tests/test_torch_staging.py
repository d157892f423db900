"""The request's staging arena (``yolort_tpu_torch/utils/staging.py``) and
``YOLOv5.__call__``'s upload through it, JAX-free.

- On the CPU, through a plain host buffer (``StagingArena(pinned=False)``,
  the same code the card runs with a pinned one): the buffer is reused for
  an equal or smaller request and grows once for a larger one; each view
  holds the bytes ``np.stack`` (or the frame itself) would, for uint8 and
  float32 frames and the ``fixed_shape`` layout of mixed sizes and dtypes;
  the float32 size slot sits at an aligned offset and reads ``[h, w]``
  back; ``count.staged`` is 1 a group uploaded, ``count.staging_grown`` 1
  an allocation; ``__call__`` through the arena gives what the CPU path
  gives, and the CPU path gives what the pageable per-bucket and
  per-frame forms give; threads sharing an instance each get their own
  detections.
- On the card (``cuda`` marker; skips without one): ``__call__``'s
  detections are bit-identical to the pageable form on both bucket dtypes
  and on a ``fixed_shape`` request of mixed sizes; back-to-back calls on
  different frames each return their own; larger, smaller, larger requests
  regrow the arena:

    python -m pytest --noconftest tests/test_torch_staging.py -m cuda
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import yolort_tpu_torch
from yolort_tpu_torch.utils.profiling import shift_head_bias
from yolort_tpu_torch.utils.staging import ALIGN, StagingArena, layout, part_spec

SIDE = 96
FIXED = (96, 96)


def tiny(device="cpu", fixed=None):
    m = yolort_tpu_torch.yolov5n(device=device, size=(SIDE, SIDE), fixed_shape=fixed,
                                 score_thresh=0.25, pre_nms_topk=128, detections_per_img=40)
    shift_head_bias(m.model, 7.0)
    return m


def frames(seed, shapes, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]
    return [rng.random((*s, 3), dtype=np.float32) for s in shapes]


def counted(fn):
    """``fn()`` under the profiler, and its {counter: total} of the arena's
    two counters."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    totals = {"staged": 0, "staging_grown": 0}
    for e in prof.profiler.kineto_results.events():
        name = e.name().rsplit("count.", 1)[-1]
        if e.name().startswith("yolort_tpu::count.") and name in totals:
            totals[name] += int(e.concrete_inputs()[0])
    return out, totals


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def unpacked(m, det, n):
    out = [None] * n
    m._unpack(det, range(n), out)
    return out


def pageable_bucket(m, imgs, device="cpu"):
    """One shape bucket in its pageable form: ``np.stack``, a pageable copy,
    the size tensor made by ``torch.tensor`` on the device."""
    orig = torch.tensor(imgs[0].shape[:2], dtype=torch.float32, device=device)
    det = m._infer(torch.from_numpy(np.stack(imgs)).to(device), orig)
    return unpacked(m, det, len(imgs))


def per_frame_mixed(m, imgs, device="cpu"):
    """A mixed ``fixed_shape`` request in its per-frame form: a copy a frame,
    the sizes by ``torch.tensor``."""
    with torch.inference_mode():
        raws = [torch.from_numpy(np.ascontiguousarray(im)).to(device) for im in imgs]
        orig = torch.tensor([im.shape[:2] for im in imgs], dtype=torch.float32, device=device)
        det = m._infer_fixed(m.canvas_mixed(raws), orig)
    return unpacked(m, det, len(imgs))


def bucket_parts(imgs):
    return [list(imgs), np.array(imgs[0].shape[:2], np.float32)]


# --- the arena on a plain host buffer -----------------------------------------------------------


def test_arena_is_reused_for_an_equal_or_smaller_request_and_grows_once_for_a_larger():
    arena = StagingArena(pinned=False)
    two, one, three = (frames(0, [(72, 96)] * n) for n in (2, 1, 3))

    def stage(imgs):
        arena.stage(bucket_parts(imgs))
        arena.upload("cpu")
        return arena._host.data_ptr(), arena._host.numel()

    def sequence():
        return [stage(x) for x in (two, two, one, three, one, two)]

    got, totals = counted(sequence)
    ptrs = [p for p, _ in got]
    assert ptrs[0] == ptrs[1] == ptrs[2] and ptrs[3] == ptrs[4] == ptrs[5] != ptrs[0]
    assert [n for _, n in got] == [layout([part_spec(p) for p in bucket_parts(x)])[1]
                                   for x in (two, two, two, three, three, three)]
    assert totals == {"staged": 6, "staging_grown": 2}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_a_bucket_view_holds_the_bytes_np_stack_would(dtype):
    arena = StagingArena(pinned=False)
    imgs = frames(1, [(72, 96)] * 3, dtype)
    arena.stage(bucket_parts(imgs))
    raw, orig = arena.upload("cpu")
    want = np.stack(imgs)
    assert raw.dtype == torch.from_numpy(want).dtype and raw.shape == want.shape
    assert raw.numpy().tobytes() == want.tobytes()
    assert orig.dtype == torch.float32 and orig.tolist() == [72.0, 96.0]
    # the host bytes of the arena are the stack, from its first byte
    assert arena._host.numpy()[:want.nbytes].tobytes() == want.tobytes()


def test_the_mixed_layout_holds_each_frame_and_the_sizes():
    arena = StagingArena(pinned=False)
    # an odd byte count first (5 x 7 x 3), then a float frame, then the sizes
    imgs = frames(2, [(5, 7), (72, 96)]) + frames(3, [(50, 80)], np.float32)
    imgs.append(frames(4, [(96, 64)])[0][::-1, :, ::-1])  # strided, as cv2 BGR->RGB leaves it
    sizes = np.array([im.shape[:2] for im in imgs], np.float32)
    arena.stage(imgs + [sizes])
    *raws, orig = arena.upload("cpu")
    for r, im in zip(raws, imgs):
        assert r.shape == im.shape and r.dtype == torch.from_numpy(im.copy()).dtype
        assert r.numpy().tobytes() == np.ascontiguousarray(im).tobytes()
    assert np.array_equal(orig.numpy(), sizes)


@pytest.mark.parametrize("shape", [(5, 7), (72, 96), (1, 1)])
def test_the_size_slot_is_aligned_and_reads_back(shape):
    parts = bucket_parts(frames(5, [shape] * 3))
    offsets, total = layout([part_spec(p) for p in parts])
    assert offsets[0] == 0 and offsets[1] % ALIGN == 0 and offsets[1] % 4 == 0
    assert offsets[1] >= 3 * shape[0] * shape[1] * 3 and total == offsets[1] + 8
    arena = StagingArena(pinned=False)
    arena.stage(parts)
    host = arena._host.numpy()
    assert host[offsets[1]:total].view(np.float32).tolist() == [float(shape[0]), float(shape[1])]
    assert arena.upload("cpu")[1].tolist() == [float(shape[0]), float(shape[1])]


def test_each_upload_is_a_copy_of_its_own():
    arena = StagingArena(pinned=False)
    a, b = frames(6, [(72, 96)] * 2), frames(7, [(72, 96)] * 2)
    arena.stage(bucket_parts(a))
    raw_a, _ = arena.upload("cpu")
    arena.stage(bucket_parts(b))
    raw_b, _ = arena.upload("cpu")
    assert np.array_equal(raw_a.numpy(), np.stack(a)) and np.array_equal(raw_b.numpy(), np.stack(b))


# --- __call__ ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bucket_model():
    return tiny()


@pytest.fixture(scope="module")
def fixed_model():
    return tiny(fixed=FIXED)


def test_the_cpu_path_keeps_no_arena_and_gives_the_pageable_forms_detections(bucket_model,
                                                                            fixed_model):
    assert bucket_model._arena is None and fixed_model._arena is None
    imgs = frames(8, [(72, 96)] * 2)
    floats = frames(9, [(50, 80)] * 2, np.float32)
    got = bucket_model(imgs + floats)
    same(got, pageable_bucket(bucket_model, imgs) + pageable_bucket(bucket_model, floats))
    mixed = frames(10, [(72, 96), (96, 64)]) + frames(11, [(50, 80)], np.float32)
    same(fixed_model(mixed), per_frame_mixed(fixed_model, mixed))


@pytest.mark.parametrize("path", ["bucket", "fixed_mixed"])
def test_call_through_the_arena_gives_the_cpu_paths_detections(path, bucket_model, fixed_model):
    m = bucket_model if path == "bucket" else fixed_model
    imgs = frames(12, [(72, 96), (72, 96), (96, 64)]) + frames(13, [(50, 80)], np.float32)
    want = m(imgs)
    m._arena = StagingArena(pinned=False)
    try:
        got, totals = counted(lambda: [m(imgs), m(imgs)])
    finally:
        m._arena = None
    same(got[0], want)
    same(got[1], want)
    # three groups in order, (72, 96) x 2 u8 (41,472 bytes), (96, 64) u8 (18,432) and (50, 80)
    # f32 (48,000): grown for the first and the third; or one request on the canvas
    groups, grown = (3, 2) if path == "bucket" else (1, 1)
    assert totals == {"staged": 2 * groups, "staging_grown": grown}


def test_threads_sharing_an_instance_each_get_their_own_detections(bucket_model):
    m = bucket_model
    requests = [frames(20 + i, [(72, 96)] * 2) for i in range(8)]
    wants = [m(r) for r in requests]
    m._arena = StagingArena(pinned=False)
    errors = []

    def worker(i):
        try:
            for _ in range(3):
                same(m(requests[i]), wants[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
        m._arena = None
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


# --- on the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_call_on_the_card_is_bit_identical_to_the_pageable_form(cuda_device, dtype):
    m = tiny(cuda_device)
    imgs = frames(30, [(72, 96)] * 4, dtype)
    got = m(imgs)
    assert m._arena is not None and m._arena._host.is_pinned()
    want = pageable_bucket(m, imgs, cuda_device)
    same(got, want)
    assert sum(len(g["boxes"]) for g in got) > 0


@pytest.mark.cuda
def test_a_mixed_fixed_shape_request_on_the_card_matches_the_per_frame_form(cuda_device):
    m = tiny(cuda_device, fixed=FIXED)
    imgs = frames(31, [(72, 96), (5, 7), (96, 64)]) + frames(32, [(50, 80)], np.float32)
    got = m(imgs)
    same(got, per_frame_mixed(m, imgs, cuda_device))
    assert sum(len(g["boxes"]) for g in got) > 0


@pytest.mark.cuda
def test_back_to_back_calls_on_the_card_return_their_own_detections(cuda_device):
    m = tiny(cuda_device)
    a, b = frames(33, [(72, 96)] * 4), frames(34, [(72, 96)] * 4)
    want_a, want_b = pageable_bucket(m, a, cuda_device), pageable_bucket(m, b, cuda_device)
    got = [m(a), m(b), m(a), m(b)]
    same(got[0], want_a)
    same(got[1], want_b)
    same(got[2], want_a)
    same(got[3], want_b)


@pytest.mark.cuda
def test_larger_smaller_larger_requests_regrow_the_arena_on_the_card(cuda_device):
    m = tiny(cuda_device)
    sizes = {}
    for n in (2, 1, 6, 3, 8):
        imgs = frames(40 + n, [(72, 96)] * n)
        (got, totals) = counted(lambda: m(imgs))
        same(got, pageable_bucket(m, imgs, cuda_device))
        sizes[n] = (m._arena._host.numel(), totals["staging_grown"])
        assert m._arena._host.is_pinned() and totals["staged"] == 1
    need = {n: layout([part_spec(p) for p in bucket_parts(frames(0, [(72, 96)] * n))])[1]
            for n in sizes}
    assert sizes == {2: (need[2], 1), 1: (need[2], 0), 6: (need[6], 1), 3: (need[6], 0),
                     8: (need[8], 1)}
