"""Shared by the ``epilogue_fused`` readers: the program's ``epilogue_fused``
and ``epilogue_plain`` counters (``Detector.head_outputs``,
``yolort_tpu_torch/models/yolo.py``), one pair a call of the network: of its
float convs with a bias, those whose bias and activation the program's
``bias_act`` kernel applied, and the rest.

Returns None where the trace holds no device event, no program span, or no
such count (a program that counts no epilogue)."""

from __future__ import annotations

from typing import Optional

from portbench.layers._program import counted


def epilogue_fused_pct(run) -> Optional[float]:
    """Biased float convs whose epilogue took the kernel, over all of them,
    summed over the traced window, in %."""
    fused, plain = counted(run, "epilogue_fused"), counted(run, "epilogue_plain")
    if fused is None or plain is None or fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
