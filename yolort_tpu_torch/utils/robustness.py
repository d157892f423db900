"""Timeouts, retries, checkpoint integrity and the checkpoint downloader.

Port of ``yolort_tpu/utils/robustness.py`` (standard library only):

  * ``Timeout`` enforces a wall-clock limit through SIGALRM and restores
    the handler and the interval timer it found when it ends, so an outer
    ``Timeout`` (or a test runner's own alarm) keeps running;
  * ``retry``, ``sha256_prefix`` and ``verify_checkpoint`` (the sha256
    prefix that release file names carry, as in ``...-9f44bf3f.pt``);
  * ``PRETRAINED_REGISTRY`` (the sha-suffixed names of the COCO
    checkpoints), ``hub_base`` and ``pretrained_url``;
  * ``attempt_download``: retry, byte-Range resume of a ``.part`` file and
    the sha256-prefix check, in urllib.

Downloads are opt-in: ``hub_base`` is None, and nothing is fetched,
unless ``YOLORT_HUB_BASE`` names a mirror (or ``default`` for the release
base).
"""

from __future__ import annotations

import hashlib
import os
import signal
import time
from pathlib import Path
from typing import Callable, Optional


class Timeout:
    """Context manager enforcing a wall-clock limit through SIGALRM, in
    the main thread.  With ``suppress`` the ``TimeoutError`` it raises ends
    the ``with`` block quietly.  On exit the previous SIGALRM handler is
    put back, and so is a timer that was running before, less the time
    spent inside."""

    def __init__(self, seconds: float, timeout_msg: str = "", suppress: bool = True):
        self.seconds = seconds
        self.msg = timeout_msg
        self.suppress = suppress

    def _handler(self, signum, frame):
        raise TimeoutError(self.msg or f"operation exceeded {self.seconds}s")

    def __enter__(self):
        self._old = signal.signal(signal.SIGALRM, self._handler)
        self._start = time.monotonic()
        self._old_timer = signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, exc_type, exc, tb):
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self._old)
        delay, interval = self._old_timer
        if delay > 0:
            # an outer timer that fell due inside fires at once
            remaining = max(delay - (time.monotonic() - self._start), 1e-6)
            signal.setitimer(signal.ITIMER_REAL, remaining, interval)
        return self.suppress and exc_type is TimeoutError


def retry(fn: Callable, attempts: int = 3, delay: float = 0.5, exceptions=(Exception,)):
    """Call ``fn`` with up to ``attempts`` tries and a linear back-off."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            last = e
            if i < attempts - 1:
                time.sleep(delay * (i + 1))
    raise last


def sha256_prefix(path: str, length: int = 8) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:length]


def _name_hash(path: Path) -> Optional[str]:
    """The trailing ``-<hex>`` token of a file name's stem (6 or more hex
    digits), the sha256 prefix a release name carries; else None."""
    stem = path.stem
    if "-" in stem:
        candidate = stem.rsplit("-", 1)[-1]
        if len(candidate) >= 6 and all(c in "0123456789abcdef" for c in candidate):
            return candidate
    return None


def verify_checkpoint(path: str, hash_prefix: Optional[str] = None) -> bool:
    """Whether a local checkpoint's sha256 starts with ``hash_prefix``
    (default: the prefix its name carries; a name without one verifies)."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(path)
    if hash_prefix is None:
        hash_prefix = _name_hash(p)
    if hash_prefix is None:
        return True  # nothing to verify against
    return sha256_prefix(path, len(hash_prefix)) == hash_prefix


# The COCO checkpoints of the model zoo, by arch: the release names, each
# ending in the sha256 prefix of its .pt.  No file is in the repository:
# they are placed in the weights directory or fetched from a hub mirror.
PRETRAINED_REGISTRY = {
    "yolov5_darknet_pan_s_r31": "yolov5_darknet_pan_s_r31_coco-eb728698",
    "yolov5_darknet_pan_m_r31": "yolov5_darknet_pan_m_r31_coco-670dc553",
    "yolov5_darknet_pan_l_r31": "yolov5_darknet_pan_l_r31_coco-4dcc8209",
    "yolov5_darknet_pan_s_r40": "yolov5_darknet_pan_s_r40_coco-e3fd213d",
    "yolov5_darknet_pan_m_r40": "yolov5_darknet_pan_m_r40_coco-d295cb02",
    "yolov5_darknet_pan_l_r40": "yolov5_darknet_pan_l_r40_coco-4416841f",
    "yolov5_darknet_pan_n_r60": "yolov5_darknet_pan_n_r60_coco-bc15659e",
    "yolov5_darknet_pan_n6_r60": "yolov5_darknet_pan_n6_r60_coco-4e823e0f",
    "yolov5_darknet_pan_s_r60": "yolov5_darknet_pan_s_r60_coco-9f44bf3f",
    "yolov5_darknet_pan_s6_r60": "yolov5_darknet_pan_s6_r60_coco-b4ff1fc2",
    "yolov5_darknet_pan_m_r60": "yolov5_darknet_pan_m_r60_coco-58d32352",
    "yolov5_darknet_pan_m6_r60": "yolov5_darknet_pan_m6_r60_coco-cc010533",
    "yolov5_darknet_pan_l_r60": "yolov5_darknet_pan_l_r60_coco-321d8dcd",
    "yolov5_darknet_tan_s_r40": "yolov5_darknet_tan_s_r40_coco-fe1069ce",
}

# The release base the registry's names are published under.
DEFAULT_HUB_BASE = "https://github.com/zhiqwang/yolov5-rt-stack/releases/download/v0.6.0"


def hub_base() -> Optional[str]:
    """The hub base URL, or None (the default) when downloads are off:
    ``YOLORT_HUB_BASE`` names a mirror, or is ``default`` (or ``1`` /
    ``true``) for ``DEFAULT_HUB_BASE``."""
    base = os.environ.get("YOLORT_HUB_BASE", "")
    if not base:
        return None
    if base.lower() in ("default", "1", "true"):
        return DEFAULT_HUB_BASE
    return base.rstrip("/")


def pretrained_url(arch: str, base: Optional[str] = None) -> Optional[str]:
    """The URL of an arch's COCO checkpoint (its registry name) on ``base``
    (default ``hub_base()``), or None where there is no hub or no entry."""
    base = base if base is not None else hub_base()
    if base is None or arch not in PRETRAINED_REGISTRY:
        return None
    return f"{base}/{PRETRAINED_REGISTRY[arch]}.pt"


def attempt_download(
    url: str,
    dest,
    hash_prefix: Optional[str] = None,
    attempts: int = 3,
    delay: float = 0.5,
    timeout: float = 30.0,
    resume: bool = True,
    min_bytes: int = 1,
    chunk_bytes: int = 1 << 20,
):
    """Download ``url`` to ``dest`` with retries, byte-Range resume and the
    sha256-prefix check; returns the ``dest`` Path.

    - The data streams into ``dest + '.part'``.  A retry resumes from the
      partial file with ``Range: bytes=<pos>-`` (a server answering 200
      instead of 206 restarts the file).  Only a download with a
      ``hash_prefix`` resumes: without one a stale partial file cannot be
      validated, so every attempt starts from byte 0.
    - ``hash_prefix`` defaults to the ``-<hex>`` token of ``dest``'s name.
      A mismatch deletes the partial file and counts as a failed attempt.
    - A file already at ``dest`` that verifies is returned unfetched; one
      that does not is deleted.
    - On success the partial file is renamed to ``dest``.

    Raises the last error after ``attempts`` failures (at once on HTTP 403,
    404 or 410); a partial file is kept for a later resume unless its hash
    mismatched."""
    import urllib.error
    import urllib.request

    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if hash_prefix is None:
        hash_prefix = _name_hash(dest)
    if dest.exists() and dest.stat().st_size >= min_bytes:
        if hash_prefix is None or sha256_prefix(dest, len(hash_prefix)) == hash_prefix:
            return dest
        dest.unlink()
    if attempts < 1:
        raise ValueError(f"attempts={attempts} must be >= 1")
    part = dest.with_name(dest.name + ".part")
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            pos = (part.stat().st_size
                   if (resume and hash_prefix is not None and part.exists()) else 0)
            req = urllib.request.Request(url)
            if pos > 0:
                req.add_header("Range", f"bytes={pos}-")
            with urllib.request.urlopen(req, timeout=timeout) as r:
                if pos > 0 and getattr(r, "status", 200) != 206:
                    pos = 0  # the server ignored the Range header: restart
                length = r.headers.get("Content-Length")
                expected = pos + int(length) if length is not None else None
                with open(part, "ab" if pos > 0 else "wb") as f:
                    while True:
                        block = r.read(chunk_bytes)
                        if not block:
                            break
                        f.write(block)
            if expected is not None and part.stat().st_size < expected:
                # the connection died mid-stream: keep the bytes for a resume
                raise OSError(f"truncated download: {part.stat().st_size}/{expected} bytes")
            if part.stat().st_size < min_bytes:
                raise OSError(f"downloaded {part.stat().st_size} bytes < min_bytes={min_bytes}")
            if hash_prefix is not None:
                got = sha256_prefix(part, len(hash_prefix))
                if got != hash_prefix:
                    part.unlink()  # poisoned data: never resume from it
                    raise ValueError(f"sha256 mismatch for {url}: got {got}, want {hash_prefix}")
            part.replace(dest)
            return dest
        except (OSError, ValueError, urllib.error.URLError) as e:
            last = e
            if isinstance(e, urllib.error.HTTPError) and e.code in (403, 404, 410):
                break  # the asset does not exist: a retry cannot help
            if i < attempts - 1:
                time.sleep(delay * (i + 1))
    raise last
