"""The CUDA row-scan kernel against the XLA row scan, on the card.

Marked ``gpu``: the kernel has no CPU mode, so these skip without a
card.  On a machine with one: ``HASLR_TEST_PLATFORM=gpu python -m pytest
-m gpu tests/``.  ``chip_smoke.py`` repeats the comparison at the
production bucket shapes with 4096 reads each."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from haslr_tpu.kernels import nw_rowscan as rs
from test_nw_rowscan import _mutated_batch


def _batch(seed, B, S):
    rng = np.random.default_rng(seed)
    reads, r_lens, drafts, d_lens = _mutated_batch(
        rng, B, S, sub=0.05, ins=0.04, dele=0.04
    )
    # out-of-gate rows and a read with no draft stay deterministic too
    r_lens[0], d_lens[0] = 40, S - 20
    r_lens[1], d_lens[1] = S - 20, 40
    d_lens[2] = 0
    return (jnp.asarray(reads), jnp.asarray(r_lens), jnp.asarray(drafts),
            jnp.asarray(d_lens))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [128, 512, 1024])
def test_kernel_mapping_matches_xla(gpu, S):
    assert rs.use_kernel(S, S, 128)
    args = _batch(S, 96, S)
    got = jax.jit(rs.rowscan_mapping, static_argnums=range(4, 10))(
        *args, S, S, 128, 5, -4, -8)
    want = jax.jit(rs._rowscan_mapping_inner, static_argnums=range(4, 10))(
        *args, S, S, 128, 5, -4, -8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
@pytest.mark.parametrize("S,maxr", [(256, 128), (1024, 32)])
def test_kernel_cigar_runs_match_xla(gpu, S, maxr):
    args = _batch(S + 1, 96, S)
    runs, n = jax.jit(rs.rowscan_cigar, static_argnums=range(4, 11))(
        *args, S, S, 128, 2, -4, -2, maxr)
    want_runs, want_n = jax.jit(
        rs._rowscan_cigar_inner, static_argnums=range(4, 11)
    )(*args, S, S, 128, 2, -4, -2, maxr)
    np.testing.assert_array_equal(np.asarray(n), np.asarray(want_n))
    np.testing.assert_array_equal(np.asarray(runs), np.asarray(want_runs))


@pytest.mark.gpu
def test_kernel_under_shard_map(gpu):
    """The FFI call inside the production shard_maps (check_vma=True):
    sharded CIGAR runs and consensus equal the single-device results."""
    from haslr_tpu.dist.mesh import make_mesh
    from haslr_tpu.kernels.consensus import batched_consensus

    mesh = make_mesh(len(jax.devices()))
    S, B = 512, 64 * len(jax.devices())
    reads, r_lens, drafts, d_lens = (np.asarray(x) for x in _batch(7, B, S))
    one = rs.cigar_runs_device_raw(reads, r_lens, drafts, d_lens)
    sharded = rs.cigar_runs_device_sharded(reads, r_lens, drafts, d_lens,
                                           mesh)
    for a, b in zip(one, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    rng = np.random.default_rng(3)
    windows = []
    for L in (200, 400, 700):
        true = "".join("ACGT"[i] for i in rng.integers(0, 4, L))
        windows.append([true[: L - k] for k in range(0, 9, 2)])
    assert batched_consensus(windows, mesh=mesh) == batched_consensus(windows)
