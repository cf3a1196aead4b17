"""Packaging for paddle_tpu (reference layer 0: CMake build + wheel;
here the Python package + the native C++ runtime pieces, which
compile on first import via the system toolchain — see
paddle_tpu/native/__init__.py)."""

import os

from setuptools import find_packages, setup


def _read_version():
    return "0.2.0"  # round-2 snapshot


setup(
    name="paddle_tpu",
    version=_read_version(),
    description=("TPU-native deep-learning framework with the PaddlePaddle "
                 "v1.6 fluid capability surface: Program/Executor static "
                 "graphs compiled whole-block to XLA, dygraph, fleet "
                 "distribution, PS runtime, inference engine"),
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    py_modules=["bench"],
    package_data={
        "paddle_tpu": ["native/csrc/*.cc", "native/csrc_capi/*.cc"],
        "paddle_tpu_torch": ["kernels/csrc/*.cu", "kernels/csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    entry_points={
        "console_scripts": [
            "paddle-tpu-bench=bench:main",
        ],
    },
)
