"""The benchmark's own tests: `python -m pytest perfbench/tests -q`.

Tests that need the card carry the `gpu` marker and skip without one;
whether a card is present is decided inside the `cuda_card` fixture.
"""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")


@pytest.fixture
def small():
    return shrink


def shrink(cell):
    """The cell's configuration and traffic at a size the CPU tests hold:
    the published widths, few lanes, float32 compute."""
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    config["network"]["compute_dtype"] = "float32"
    if traffic["driver"] == "train":
        config["training"].update(num_envs=8, rollout_steps=8, batch_size=16)
    else:
        traffic.update(episodes=16, chunk=16, sample_from=2)
    return config, traffic
