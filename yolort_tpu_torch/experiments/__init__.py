"""Timing entry points for the port's kernels on the card, each run with
``python -m yolort_tpu_torch.experiments.<name>``:

  * ``lookup_kernel_variants``: where ``lookup_fetch``'s time goes, by its
    stripped variants (search, metadata, row copy);
  * ``fetch_block_sweep``: ``row_fetch`` over a sweep of launch geometries
    at the stage-2 chunk shape and the cells shape.

``timing`` holds the measurement helpers they share with ``chip_smoke.py``.
Importing any of them runs nothing and needs no CUDA; their ``main`` needs
a CUDA device and raises without one.
"""
