"""Packaging (reference: `/root/reference/setup.py`)."""
from setuptools import find_packages, setup

setup(
    name="bbx",
    version="0.1.0",
    description="Block Blast on XLA: a TPU-native RL framework",
    packages=find_packages(include=["bbx", "bbx.*", "bbx_torch", "bbx_torch.*"]),
    package_data={"bbx_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pyyaml",
    ],
    extras_require={
        "dev": ["pytest", "chex"],
        "gym": ["gymnasium"],
    },
    entry_points={
        "console_scripts": [
            "bbx-train=bbx.cli.train:main",
            "bbx-evaluate=bbx.cli.evaluate:main",
            "bbx-play=bbx.cli.play:main",
            "bbx-benchmark=bbx.cli.benchmark:main",
            "bbx-torch-train=bbx_torch.cli.train:main",
            "bbx-torch-evaluate=bbx_torch.cli.evaluate:main",
            "bbx-torch-play=bbx_torch.cli.play:main",
            "bbx-torch-benchmark=bbx_torch.cli.benchmark:main",
            "bbx-torch-gui=bbx_torch.gui.__main__:main",
            "bbx-torch-stable-train=bbx_torch.cli.stable_train:main",
            "bbx-torch-quick-bench=bbx_torch.cli.quick_bench:main",
        ],
    },
)
