"""Test configuration.

The suite runs on the CPU with 8 virtual devices, so sharding tests work
without a card (SURVEY.md §4.9): that is what an unset ``JAX_PLATFORMS``,
or one that starts with ``cpu``, gets.  Any other value belongs to the
caller (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on the card,
or ``chip_smoke.py``), and this file leaves the platform alone.

Tests marked ``gpu`` take the ``gpu`` fixture, which decides at run time
whether a card is present and skips the test otherwise; nothing here
decides it while modules are imported, so every worker collects the same
tests.
"""

import os

import pytest

_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms.split(",")[0] in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = _platforms or "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", _platforms or "cpu")
    assert jax.device_count() >= 8, "virtual CPU mesh not active"


@pytest.fixture
def gpu():
    """The first NVIDIA GPU, made the default device for the test; skips
    the test when JAX has none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: run JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/ on the card")
    with jax.default_device(devices[0]):
        yield devices[0]
