"""Test configuration: JAX on 8 virtual CPU devices, plus the GPU if any.

Every test runs on the CPU backend, which gets 8 host devices so the
multi-device sharding paths run without a multi-GPU machine (SURVEY.md
section 4, point 3).  Listing ``cuda`` after ``cpu`` keeps the CPU the
default backend and, on a machine with an NVIDIA GPU, also brings up the
card for the tests marked ``gpu``; JAX skips ``cuda`` where no card is
visible.  Those tests ask for the ``gpu_device`` fixture, which skips them
when there is no card.  On the card:

    python -m pytest -m gpu tests/
"""

import os

import pytest

# the GPU lane shares the card between test workers: allocate on demand
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu,cuda")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on an NVIDIA GPU (skips where there is none)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
