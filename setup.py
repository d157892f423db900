from pathlib import Path

from setuptools import find_packages, setup

setup(
    name="yolort_tpu",
    version="0.1.0",
    description="TPU-native YOLOv5 runtime stack (JAX/XLA/Pallas)",
    long_description=(Path(__file__).parent / "README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=find_packages(
        include=["yolort_tpu", "yolort_tpu.*", "yolort_tpu_torch", "yolort_tpu_torch.*"]
    ),
    # the port's CUDA sources, compiled with nvcc at first kernel launch, and
    # the C++ op library of its driver (deployment/libtorch), built with g++
    package_data={"yolort_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "convert": ["torch"],  # only needed to ingest ultralytics .pt checkpoints
        "vision": ["opencv-python", "pillow"],
        "train": ["optax"],
        "torch": ["torch"],  # yolort_tpu_torch, the PyTorch/CUDA port
    },
    entry_points={
        "console_scripts": [
            "yolort-tpu-export=tools.export_model:cli_main",
            "yolort-tpu-eval=tools.eval_metric:cli_main",
        ]
    },
)
