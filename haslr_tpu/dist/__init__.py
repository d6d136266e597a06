"""Multi-chip scaling: device meshes, data-parallel long-read streaming,
psum-merged edge support.

The reference is single-node (SURVEY.md §2.3); the multi-device mapping is:
the SR-contig/minimizer index is replicated per host, long reads stream
data-parallel across the mesh, per-edge support counts merge with
``jax.lax.psum``, and graph cleaning runs replicated on the reduced
backbone.

Multi-host bring-up: call :func:`initialize` once per process (before any
device use), shard the long-read stream with
``map_reads(..., host_shard=host_shard())``, and pass
``mesh.make_mesh()`` (all global devices) to ``run_assembler``/
``calc_consensus`` — the consensus stage psum-merges over the mesh and
every host computes identical drafts, so graph cleaning and stitching
stay replicated-deterministic.
"""

from __future__ import annotations


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: int | None = None) -> None:
    """Bring up ``jax.distributed`` for multi-host runs.

    All-``None`` arguments auto-detect the cluster environment (cluster
    metadata / SLURM), matching ``jax.distributed.initialize`` semantics;
    detection failures then leave JAX in single-process mode.  With
    EXPLICIT arguments, errors propagate — a typo'd coordinator address
    must fail the run, not silently degrade every process to its own
    single-process world with divergent assemblies.
    """
    import jax

    explicit = coordinator_address is not None or process_id is not None
    kwargs = {}
    if timeout_s is not None:
        kwargs["initialization_timeout"] = timeout_s
    try:
        jax.distributed.initialize(
            coordinator_address, num_processes, process_id, **kwargs
        )
    except (RuntimeError, ValueError):
        if explicit:
            raise
        # already initialized, or no cluster environment detected —
        # single-process mode, mirroring the reference's single-node run
        pass


def host_shard() -> tuple[int, int]:
    """(process_index, process_count) — the round-robin shard this host
    owns in the data-parallel long-read stream."""
    import jax

    return jax.process_index(), jax.process_count()
