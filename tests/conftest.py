"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU backend (8 virtual devices stand in for a
multi-card mesh); tests that need the GPU carry the ``gpu`` marker and
skip here.  The program runs on the GPU through its entry points
(``python -m haslr_tpu.cli.haslr``, whose ``--platform`` defaults to
``gpu``) and ``chip_smoke.py``; ``python -m pytest -m gpu tests/`` runs
the card-only tests on a machine with a card.  The updates below take
effect because no backend is initialized yet.
"""

import os

import jax
import pytest

if os.environ.get("HASLR_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import or collection time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (the CUDA kernel has no CPU mode)")
    return jax.devices()[0]
