"""The benchmark of the PyTorch and CUDA port (``yolort_tpu_torch``): see ``run.py``."""
