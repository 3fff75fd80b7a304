"""Checks that need an NVIDIA GPU. They skip elsewhere; on a card run

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

chip_smoke.py runs the same functions in its own process."""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")
    return jax.devices()[0]


def test_flagship_forward_on_gpu_matches_cpu(gpu):
    """desire_forward compiled for the card against the CPU backend, float32
    under "highest" precision, at full widths (chip_smoke's parity phase)."""
    chip_smoke.phase_parity(chip_smoke.SIZES["flagship"], 0, gpu)
