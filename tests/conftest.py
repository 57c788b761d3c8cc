"""Test harness config: CPU backend with 8 virtual devices.

The tests run on the CPU unless JAX_PLATFORMS says otherwise (the
``gpu``-marked tests run on the card with ``JAX_PLATFORMS=cuda``).  8
host devices emulate a multi-device mesh for the sharding tests (the
analog of the reference's -deviceemu CPU emulation build,
common.mk:198-205 — see SURVEY.md §4).
"""

import os
import warnings

import numpy as np

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
# Hermetic tests: never read/write the persistent compilation cache
# (ugrt.api.cli enables it when its CLI main runs inside a test).
jax.config.update("jax_enable_compilation_cache", False)

warnings.filterwarnings("ignore")
np.seterr(all="ignore")

import dataclasses  # noqa: E402

import pytest  # noqa: E402

from ugrt.config import RenderConfig  # noqa: E402
from ugrt.core import camera as cam  # noqa: E402
from ugrt.scene import procedural  # noqa: E402


@pytest.fixture(scope="session")
def small_cfg():
    """128x128 image over a 16x16 grid — fast oracle comparisons."""
    return dataclasses.replace(RenderConfig(), screen_width=128,
                               screen_height=128, grid_x=16, grid_y=16)


@pytest.fixture(scope="session")
def tiny_cfg():
    """64x64 image over an 8x8 grid."""
    return dataclasses.replace(RenderConfig(), screen_width=64,
                               screen_height=64, grid_x=8, grid_y=8)


@pytest.fixture(scope="session")
def cornell():
    return procedural.cornell_box(subdiv=2)


@pytest.fixture(scope="session")
def generic_camera():
    """Deliberately non-symmetric so no ray lies exactly on a triangle
    edge (knife-edge winners are FMA-order dependent)."""
    return cam.CameraSpec(eye=(0.123, 0.071, 2.531),
                          look_at=(-0.037, 0.011, 0.0),
                          up=(0.02, 1.0, 0.013), near=0.1, far=100.0)


@pytest.fixture(scope="session")
def generic_light():
    return cam.CameraSpec(eye=(0.13, 0.87, 0.52),
                          look_at=(0.07, -1.0, 0.49),
                          up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
