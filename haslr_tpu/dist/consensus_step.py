"""MINIMAL EXAMPLE of the psum-merged support pattern — not the
production path.

The production sharded consensus is
:func:`haslr_tpu.kernels.consensus_dense._make_sharded_rounds` (reads
data-parallel over ``dp``, vote tables psum-merged per polish round,
drafts replicated); this module is the same pattern reduced to one
readable superstep, kept as documentation-by-example and exercised by
``tests/test_dist.py::test_sharded_consensus_step_matches_single_device``.

One step of the distributed pipeline (SURVEY.md §2.3 mapping):

- a batch of (read-window, draft) pairs is sharded across the ``dp`` mesh
  axis (data-parallel long-read streaming; the contig/draft side is
  carried with each row, standing in for the replicated index);
- each device runs the banded-NW scoring DP over its shard
  (:func:`haslr_tpu.kernels.nw.nw_scores`);
- per-edge support counts (one count per backbone edge, accumulated from
  the reads each device saw) merge with ``jax.lax.psum`` over ``dp`` and
  come back replicated — exactly how edge support is globalized before the
  (replicated) graph cleaning.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from haslr_tpu.kernels import nw


def consensus_support_step(reads, r_lens, drafts, d_lens, edge_ids, n_edges,
                           W=128, min_score=0):
    """Per-shard compute: NW scores + local per-edge support histogram."""
    scores = nw.nw_scores(reads, r_lens, drafts, d_lens, W=W)
    good = scores >= min_score
    onehot = jax.nn.one_hot(edge_ids, n_edges, dtype=jnp.int32)
    local_supp = jnp.sum(onehot * good[:, None].astype(jnp.int32), axis=0)
    supp = jax.lax.psum(local_supp, "dp")
    return scores, supp


def make_sharded_step(mesh: Mesh, n_edges: int, W: int = 128):
    """Build the jitted multi-chip step: batch axis sharded over ``dp``,
    support counts psum-merged and replicated."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P()),
    )
    def _step(reads, r_lens, drafts, d_lens, edge_ids):
        return consensus_support_step(
            reads, r_lens, drafts, d_lens, edge_ids, n_edges, W=W
        )

    return jax.jit(_step)


def shard_batch(mesh: Mesh, arrays):
    """Device-put host arrays with the batch axis sharded over ``dp``."""
    out = []
    for a in arrays:
        spec = P("dp") if a.ndim >= 1 else P()
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
