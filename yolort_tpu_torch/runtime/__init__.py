"""Serving outside the eager model: the exported pipeline and its predictor
(``aot``), the AOTInductor package a C++ process serves
(``export_aoti_package``, ``deployment/libtorch``) and the pinned-buffer
streaming pipeline (``streaming``)."""

from yolort_tpu_torch.runtime.aot import (  # noqa: F401
    AOTPredictor,
    export_aot,
    export_aoti_package,
    load_aot,
)
from yolort_tpu_torch.runtime.streaming import StreamingPipeline  # noqa: F401
