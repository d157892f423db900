"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it takes the plain version.  Nothing is built at import.

A kernel module holds all of its kernels' launches: the serving kernels'
dispatcher ops (``ops/library.py``) are registered there at import, each
with its CUDA implementation, and every launch goes through
``_build.launch``, which counts it in its wrapper's ``launches``."""

from yolort_tpu_torch.ops.cuda.compact_kernel import (  # noqa: F401
    compact_place,
    compact_place_reference,
)
from yolort_tpu_torch.ops.cuda.epilogue_kernel import (  # noqa: F401
    bias_act,
    bias_act_,
    bias_act_reference,
)
from yolort_tpu_torch.ops.cuda.lookup_kernel import (  # noqa: F401
    bisect_count,
    bisect_count_reference,
    lookup_fetch,
    lookup_fetch_reference,
    lookup_fetch_variant,
    lookup_fetch_variant_reference,
    row_fetch,
    row_fetch_p,
    row_fetch_reference,
    select_extract,
    select_extract_reference,
)
from yolort_tpu_torch.ops.cuda.nms_kernel import nms_mask, nms_mask_reference  # noqa: F401
from yolort_tpu_torch.ops.cuda.qconv_kernel import (  # noqa: F401
    qconv,
    qconv1x1,
    qconv1x1_reference,
    qconv_grouped,
    qconv_grouped_reference,
    qconv_kxk,
    qconv_kxk_reference,
)
from yolort_tpu_torch.ops.cuda.stage1_kernel import (  # noqa: F401
    fused_cells_stage1,
    fused_cells_stage1_reference,
)

# every hand-written kernel, each counting its launches: the counterparts
# of the TPU kernels, then the float convs' epilogue, which no TPU kernel
# had (a float network on the card launches it once a biased conv)
KERNELS = (nms_mask, bisect_count, row_fetch, qconv1x1, qconv_kxk, qconv_grouped,
           fused_cells_stage1, lookup_fetch, select_extract, compact_place, lookup_fetch_variant,
           row_fetch_p, bias_act)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
