"""``yolort_tpu_torch.utils.robustness`` against ``yolort_tpu.utils.robustness``:
the cases of tests/test_downloads.py and tests/test_robustness.py on the
port, and the two modules' answers on the same inputs.

The downloader runs against a loopback HTTP server only (127.0.0.1, an
ephemeral port); every download is given a 10 s socket timeout and every
server handler a 10 s one, so no case can hang.  Results are exact: bytes,
hashes, booleans and the Range headers sent.
"""

import hashlib
import http.server
import signal
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from yolort_tpu.utils import robustness as JR
from yolort_tpu_torch.utils import robustness as R
from yolort_tpu_torch.utils.robustness import (
    DEFAULT_HUB_BASE, PRETRAINED_REGISTRY, Timeout, attempt_download, hub_base, pretrained_url,
    retry, sha256_prefix, verify_checkpoint,
)

PAYLOAD = bytes(np.random.default_rng(0).integers(0, 256, 300_000, dtype=np.uint8))
SHA8 = hashlib.sha256(PAYLOAD).hexdigest()[:8]
TIMEOUT_S = 10.0  # each socket operation, on both ends


@contextmanager
def serve(handler_cls):
    """A loopback HTTP server on an ephemeral port, in a daemon thread."""
    with http.server.HTTPServer(("127.0.0.1", 0), handler_cls) as srv:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            yield f"http://127.0.0.1:{srv.server_port}"
        finally:
            srv.shutdown()
            t.join(TIMEOUT_S)
            assert not t.is_alive()


class Handler(http.server.BaseHTTPRequestHandler):
    """Quiet, with a socket timeout."""

    timeout = TIMEOUT_S

    def log_message(self, *a):
        pass


class FullHandler(Handler):
    """Serves PAYLOAD; a Range request gets 206 partial content."""

    range_requests: list = []

    def do_GET(self):
        rng = self.headers.get("Range")
        if rng:
            type(self).range_requests.append(rng)
            start = int(rng.split("=")[1].rstrip("-"))
            body = PAYLOAD[start:]
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{len(PAYLOAD) - 1}/{len(PAYLOAD)}")
        else:
            body = PAYLOAD
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def download(url, dest, **kw):
    return attempt_download(url, dest, timeout=TIMEOUT_S, **kw)


def test_download_and_sha_verify(tmp_path):
    dest = tmp_path / f"weights-{SHA8}.pt"
    with serve(FullHandler) as base:
        out = download(f"{base}/weights.pt", dest)
    assert out == dest and dest.read_bytes() == PAYLOAD
    assert not dest.with_name(dest.name + ".part").exists()


def test_existing_verified_file_not_refetched(tmp_path):
    dest = tmp_path / f"weights-{SHA8}.pt"
    dest.write_bytes(PAYLOAD)
    contacted = []

    class Refuse(Handler):
        def do_GET(self):
            contacted.append(self.path)
            self.send_error(500)

    with serve(Refuse) as base:
        out = download(f"{base}/weights.pt", dest)
    assert out.read_bytes() == PAYLOAD and contacted == []


def test_a_wrong_existing_file_is_replaced(tmp_path):
    dest = tmp_path / f"weights-{SHA8}.pt"
    dest.write_bytes(b"an older file")
    with serve(FullHandler) as base:
        download(f"{base}/weights.pt", dest)
    assert dest.read_bytes() == PAYLOAD


def test_resume_from_partial(tmp_path):
    FullHandler.range_requests = []
    dest = tmp_path / f"weights-{SHA8}.pt"
    (tmp_path / f"weights-{SHA8}.pt.part").write_bytes(PAYLOAD[: len(PAYLOAD) // 2])
    with serve(FullHandler) as base:
        download(f"{base}/weights.pt", dest)
    assert dest.read_bytes() == PAYLOAD
    assert FullHandler.range_requests == [f"bytes={len(PAYLOAD) // 2}-"]


def test_resume_against_no_range_server_restarts(tmp_path):
    class NoRange(Handler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(PAYLOAD)))
            self.end_headers()
            self.wfile.write(PAYLOAD)

    dest = tmp_path / f"weights-{SHA8}.pt"
    (tmp_path / f"weights-{SHA8}.pt.part").write_bytes(b"garbage-prefix")
    with serve(NoRange) as base:
        download(f"{base}/weights.pt", dest)
    assert dest.read_bytes() == PAYLOAD


def test_sha_mismatch_raises_and_removes_poison(tmp_path):
    dest = tmp_path / "weights-deadbeef.pt"
    with serve(FullHandler) as base:
        with pytest.raises(ValueError, match="sha256 mismatch"):
            download(f"{base}/weights.pt", dest, attempts=2, delay=0.01)
    assert not dest.exists()
    assert not dest.with_name(dest.name + ".part").exists()


def test_flaky_server_retry_resumes(tmp_path):
    class Flaky(FullHandler):
        calls = [0]

        def do_GET(self):
            type(self).calls[0] += 1
            if type(self).calls[0] == 1:
                # dies mid-stream: the full length announced, half sent
                self.send_response(200)
                self.send_header("Content-Length", str(len(PAYLOAD)))
                self.end_headers()
                self.wfile.write(PAYLOAD[: len(PAYLOAD) // 2])
                self.wfile.flush()
                self.connection.close()
                return
            super().do_GET()

    Flaky.calls = [0]
    FullHandler.range_requests = []
    dest = tmp_path / f"weights-{SHA8}.pt"
    with serve(Flaky) as base:
        download(f"{base}/weights.pt", dest, attempts=3, delay=0.01)
    assert dest.read_bytes() == PAYLOAD
    assert Flaky.calls[0] >= 2
    assert any(r.startswith("bytes=") for r in FullHandler.range_requests)


@pytest.mark.parametrize("code", [404, 410, 500])
def test_http_errors_raise(tmp_path, code):
    calls = []

    class Failing(Handler):
        def do_GET(self):
            calls.append(self.path)
            self.send_error(code)

    with serve(Failing) as base:
        with pytest.raises(OSError):
            download(f"{base}/nope.pt", tmp_path / "nope.pt", attempts=2, delay=0.01)
    assert not (tmp_path / "nope.pt").exists()
    # a missing asset is not retried; a server error is
    assert len(calls) == (1 if code in (404, 410) else 2)


def test_stale_partial_without_hash_is_discarded(tmp_path):
    FullHandler.range_requests = []
    dest = tmp_path / "weights.pt"
    (tmp_path / "weights.pt.part").write_bytes(b"stale bytes from an older remote file")
    with serve(FullHandler) as base:
        download(f"{base}/weights.pt", dest)
    assert dest.read_bytes() == PAYLOAD
    assert FullHandler.range_requests == []


def test_attempts_below_one_rejected(tmp_path):
    with pytest.raises(ValueError, match="attempts=0"):
        download("http://127.0.0.1:1/x.pt", tmp_path / "x.pt", attempts=0)


def test_hub_base_gating_matches_jax(monkeypatch):
    for value in (None, "default", "TRUE", "1", "http://127.0.0.1:1/mirror/"):
        if value is None:
            monkeypatch.delenv("YOLORT_HUB_BASE", raising=False)
        else:
            monkeypatch.setenv("YOLORT_HUB_BASE", value)
        assert hub_base() == JR.hub_base()
        for arch in ("yolov5_darknet_pan_s_r60", "yolov5_darknet_pan_x_r60"):
            assert pretrained_url(arch) == JR.pretrained_url(arch)
    monkeypatch.delenv("YOLORT_HUB_BASE", raising=False)
    assert hub_base() is None and pretrained_url("yolov5_darknet_pan_s_r60") is None
    monkeypatch.setenv("YOLORT_HUB_BASE", "default")
    assert pretrained_url("yolov5_darknet_pan_s_r60") == (
        f"{DEFAULT_HUB_BASE}/{PRETRAINED_REGISTRY['yolov5_darknet_pan_s_r60']}.pt")


def test_registry_and_base_equal_jax():
    assert PRETRAINED_REGISTRY == JR.PRETRAINED_REGISTRY and len(PRETRAINED_REGISTRY) == 14
    assert DEFAULT_HUB_BASE == JR.DEFAULT_HUB_BASE
    assert PRETRAINED_REGISTRY["yolov5_darknet_pan_s_r60"].endswith("9f44bf3f")


def test_checkpoint_hash_verification_matches_jax(tmp_path):
    p = tmp_path / "weights.bin"
    p.write_bytes(b"hello world")
    prefix = sha256_prefix(str(p))
    assert prefix == JR.sha256_prefix(str(p)) and sha256_prefix(str(p), 12) == \
        JR.sha256_prefix(str(p), 12)
    named = tmp_path / f"model_coco-{prefix}.bin"
    named.write_bytes(b"hello world")
    bad = tmp_path / "model_coco-deadbeef.bin"
    bad.write_bytes(b"hello world")
    short = tmp_path / "model_coco-abc.bin"  # under 6 hex digits: no hash in the name
    short.write_bytes(b"hello world")
    for path, given in ((p, prefix), (p, "deadbeef"), (p, None), (named, None), (bad, None),
                        (short, None)):
        assert verify_checkpoint(str(path), given) == JR.verify_checkpoint(str(path), given)
    assert verify_checkpoint(str(named)) and not verify_checkpoint(str(bad))
    with pytest.raises(FileNotFoundError):
        verify_checkpoint(str(tmp_path / "missing.pt"))


def test_timeout_suppresses():
    start = time.time()
    with Timeout(0.2, "too slow"):
        time.sleep(2.0)
    assert time.time() - start < 1.0


def test_timeout_raises_when_not_suppressed():
    with pytest.raises(TimeoutError, match="0.1s"):
        with Timeout(0.1, suppress=False):
            time.sleep(1.0)


def test_timeout_restores_the_outer_handler_and_timer():
    """An inner Timeout gives back the SIGALRM handler and the running timer
    it found (a test runner's own alarm keeps counting down)."""
    fired = []

    def outer(signum, frame):
        fired.append(signum)

    old = signal.signal(signal.SIGALRM, outer)
    try:
        signal.setitimer(signal.ITIMER_REAL, 5.0)
        with Timeout(0.05):
            time.sleep(1.0)
        assert signal.getsignal(signal.SIGALRM) is outer
        left = signal.getitimer(signal.ITIMER_REAL)[0]
        assert 3.0 < left < 5.0
        signal.setitimer(signal.ITIMER_REAL, 0.05)
        time.sleep(0.5)
        assert fired == [signal.SIGALRM]
        # an outer timer that fell due inside fires as soon as the inner ends
        signal.setitimer(signal.ITIMER_REAL, 0.05)
        with Timeout(2.0):
            time.sleep(0.2)
        time.sleep(0.1)
        assert fired == [signal.SIGALRM] * 2
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def test_timeout_leaves_no_timer_where_none_ran():
    with Timeout(1.0):
        pass
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0.0


def test_retry():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ValueError("boom")
        return "ok"

    assert retry(flaky, attempts=3, delay=0.01) == "ok"
    assert calls["n"] == 3
    with pytest.raises(ValueError):
        retry(lambda: (_ for _ in ()).throw(ValueError("x")), attempts=2, delay=0.01)
    with pytest.raises(KeyError):  # not among ``exceptions``: not retried
        retry(lambda: {}["k"], attempts=3, delay=0.01, exceptions=(ValueError,))


def test_module_surface_matches_jax():
    names = ("Timeout", "retry", "sha256_prefix", "verify_checkpoint", "PRETRAINED_REGISTRY",
             "DEFAULT_HUB_BASE", "hub_base", "pretrained_url", "attempt_download")
    assert all(hasattr(R, n) and hasattr(JR, n) for n in names)
