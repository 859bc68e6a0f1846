"""Test harness: JAX on a virtual 8-device CPU platform.

``--xla_force_host_platform_device_count`` is the JAX-native "multi-node
without a cluster" mechanism; multi-chip sharding tests run against this
mesh.  Both settings must precede the first ``import jax``.  Tests that
need an NVIDIA card carry the ``gpu`` marker and ask the :func:`gpu`
fixture, which skips them without one; on the card run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def gpu():
    """The first NVIDIA device in a fresh backend query; skips without one.
    Decided here, at run time, never while modules are collected."""
    try:
        devices = jax.devices("cuda")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU")
    return devices[0]
