"""Training: the loss's task, SGD train step, EMA, train-state checkpoints
and ``fit`` with COCO evaluation (port of ``yolort_tpu/trainer``)."""

from yolort_tpu_torch.trainer.task import DefaultTask, TrainState  # noqa: F401
