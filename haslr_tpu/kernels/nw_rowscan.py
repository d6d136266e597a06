"""Row-scan banded NW: half the DP cells of the anti-diagonal wavefront.

The wavefront formulation (:mod:`haslr_tpu.kernels.nw`) advances
``T = R + D`` anti-diagonals of W lanes.  Because its band is W wide ALONG
ANTI-DIAGONALS, its per-ROW column coverage is ~2W — twice what the
admission gate (``|r_len - d_len| < W/2 - 4``) requires.  This module
scans one READ ROW per step instead: R steps x a W-lane row window
following the length-proportional diagonal, covering the same useful
drift (+-W/2 columns) with half the cells.

The in-row LEFT dependency (``H[i][j] = H[i][j-1] + gap``) that the
wavefront dodges by construction is collapsed to a closed form, exact for
linear gap penalties::

    tmp[k] = max(diag[k] + sub[k], up[k] + gap)        # prev-row only
    H[i][k] = gap*k + prefix_max(tmp[k] - gap*k)       # left-gap chains

(``prefix_max`` is an ``associative_scan`` in XLA and a warp shuffle scan
in the CUDA kernel).  Directions keep the wavefront's exact tie-break
order (DIAG preferred, then UP, then LEFT) because
``H == max(tmp, H[j-1] + gap)`` reproduces the sequential 3-candidate
max.  Traceback visits one ROW per lockstep iteration: a prefix max over
the direction row finds each read's in-row LEFT-run stop (the rightmost
non-LEFT cell at or left of its column) so a whole run of draft
deletions collapses into the single UP/DIAG move that follows it — R
iterations instead of R + D.

CAVEAT: this is a NARROWER band than the wavefront's, so mappings are not
bit-identical to the wavefront engine on extreme-drift alignments (paths
that stray >= W/2 columns off the proportional diagonal).  For every read
the admission gate accepts, real paths use a fraction of that budget; the
wavefront engine remains in-tree as the cross-check oracle
(``tests/test_nw_rowscan.py``).

Two implementations, one per bucket shape (:func:`kernel_applies`): the
W = 128 buckets run the CUDA kernel of :mod:`haslr_tpu.kernels.rowscan_gpu`
on the GPU; the W = 256/512 buckets, and every bucket on the CPU, run the
XLA scan below.  The two are bit-identical on every read, admitted or
not (``chip_smoke.py`` compares them on the card).

Reference role: SPOA's per-window sequence-to-graph alignment
(``Assemble.cpp:499-555``) and minimap2's base-level extension
(``bin/haslr.py:99``) — both served by this one batched DP.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.int32(-(10**8))
DIAG, UP, LEFT = 0, 1, 2

# the CUDA kernel's band width and longest read row: its direction rows
# live in shared memory, 32 * R bytes per read (32 KB at R = 1024)
KERNEL_W = 128
KERNEL_MAX_R = 1024


def row_bases(R: int, D: int, W: int) -> np.ndarray:
    """Lane-0 draft column per read row i in [0, R]: the
    length-proportional diagonal minus W/2, clipped and monotone.  For the
    production shapes (R == D) consecutive steps are in {0, 1}."""
    i = np.arange(R + 1, dtype=np.int64)
    center = (i * D) // max(R, 1)
    hi = max(0, D - W + 1)
    base = np.clip(center - W // 2, 0, hi)
    base = np.maximum.accumulate(base)
    return base.astype(np.int32)


def rowscan_supported(R: int, D: int, W: int) -> bool:
    """The row scan assumes the band advances by {0, 1} columns per row
    (true whenever D <= R; all production call sites pad to R == D)."""
    return D <= R or bool((np.diff(row_bases(R, D, W)) <= 1).all())


def kernel_applies(R: int, D: int, W: int) -> bool:
    """Shape rule: the CUDA kernel serves the W = 128 buckets (S <= 1024
    in ``consensus_dense._band_width`` and the aligner's extension); the
    W = 256/512 buckets run the XLA scan.  A choice by shape, not a
    fallback: both produce identical outputs."""
    return W == KERNEL_W and R <= KERNEL_MAX_R and D <= R


def use_kernel(R: int, D: int, W: int) -> bool:
    """The kernel runs where it was built for (the GPU) at the shapes of
    :func:`kernel_applies`; decided at trace time."""
    return jax.default_backend() == "gpu" and kernel_applies(R, D, W)


# --------------------------------------------------------------------------
# XLA row scan (the W = 256/512 buckets, and the CPU reference)
# --------------------------------------------------------------------------


def _shift_lanes(x, off):
    """x[..., k + off] with NEG fill; ``off`` a traced scalar in [-1, 1]."""
    B, W = x.shape
    pad = jnp.full((B, 1), NEG, dtype=x.dtype)
    xp = jnp.concatenate([pad, x, pad], axis=1)  # lanes -1 .. W
    return jax.lax.dynamic_slice_in_dim(xp, off + 1, W, axis=1)


def _rowscan_dirs_inner(reads, r_lens, drafts, d_lens, R, D, W, match,
                        mismatch, gap):
    """Row-scan DP; returns dirs (R+1, B, W) uint8."""
    B = reads.shape[0]
    base = jnp.asarray(row_bases(R, D, W))
    lanes = jnp.arange(W, dtype=jnp.int32)
    glane = (gap * lanes)[None, :]
    rl = r_lens.astype(jnp.int32)[:, None]
    dl = d_lens.astype(jnp.int32)[:, None]
    # anchor the carry to a device-varying input (shard_map vma typing)
    zero_b = (r_lens.astype(jnp.int32) * 0)[:, None]
    h0 = jnp.where(lanes[None, :] <= dl, glane, NEG) + zero_b
    drafts_p = jnp.concatenate(
        [drafts, jnp.full((B, 1), 4, drafts.dtype)], axis=1
    )

    def step(h_prev, i):
        b_i = base[i]
        s = b_i - base[i - 1]
        up = _shift_lanes(h_prev, s)
        diag = _shift_lanes(h_prev, s - 1)
        j = b_i + lanes
        rb = jax.lax.dynamic_slice_in_dim(reads, i - 1, 1, axis=1)
        db = jnp.take(drafts_p, jnp.clip(j - 1, 0, D), axis=1)
        sub = jnp.where(rb == db, match, mismatch).astype(jnp.int32)
        cand_d = diag + sub
        cand_u = up + gap
        tmp = jnp.maximum(cand_d, cand_u)
        valid = (j[None, :] <= dl) & (i <= rl)
        x = jnp.where(valid, tmp, NEG) - glane
        pm = jax.lax.associative_scan(jnp.maximum, x, axis=1)
        h = glane + pm
        d = jnp.where(
            h == cand_d,
            jnp.uint8(DIAG),
            jnp.where(h == cand_u, jnp.uint8(UP), jnp.uint8(LEFT)),
        )
        h = jnp.where(valid, h, NEG)
        return h, d

    ts = jnp.arange(1, R + 1, dtype=jnp.int32)
    _, dirs = jax.lax.scan(step, h0, ts)
    return jnp.concatenate(
        [jnp.zeros((1, B, W), dtype=jnp.uint8), dirs], axis=0
    )


def _rowscan_mapping_inner(reads, r_lens, drafts, d_lens, R, D, W, match,
                           mismatch, gap):
    """DP + row-lockstep traceback on device; mapping (B, R) int32 in the
    encoding of :func:`haslr_tpu.kernels.nw.traceback_batch`."""
    B = reads.shape[0]
    dirs = _rowscan_dirs_inner(reads, r_lens, drafts, d_lens, R, D, W,
                               match, mismatch, gap)
    base = jnp.asarray(row_bases(R, D, W))
    bidx = jnp.arange(B)
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]

    def step(carry, r):
        i, j, mapping = carry
        active = i == r
        b_r = base[r]
        lane = j - b_r
        in_band = (lane >= 0) & (lane < W)
        row = dirs[r].astype(jnp.int32)
        val_k = jnp.where(row != LEFT, (lanes << 2) | row, -1)
        pm = jax.lax.associative_scan(jnp.maximum, val_k, axis=1)
        picked = jnp.take_along_axis(
            pm, jnp.clip(lane, 0, W - 1)[:, None], axis=1
        )[:, 0]
        forced = ~in_band | (picked < 0)
        d = jnp.where(forced, jnp.int32(UP), picked & 3)
        lane_f = jnp.where(forced, lane, picked >> 2)
        jp = b_r + lane_f
        is_diag = active & (d == DIAG)
        is_up = active & (d == UP)
        write = is_diag | is_up
        val = jnp.where(is_diag, jp - 1, -(jp + 2))
        idx = jnp.where(write, i - 1, R)  # non-writers hit the dump slot
        mapping = mapping.at[bidx, idx].set(val)
        i = i - active
        j = jnp.where(is_diag, jp - 1, jnp.where(is_up, jp, j))
        return (i, j, mapping), None

    mapping0 = jnp.full((B, R + 1), -1, jnp.int32) + (
        r_lens.astype(jnp.int32) * 0
    )[:, None]
    rs = jnp.arange(R, 0, -1, dtype=jnp.int32)
    (_, _, mapping), _ = jax.lax.scan(
        step,
        (r_lens.astype(jnp.int32), d_lens.astype(jnp.int32), mapping0),
        rs,
    )
    return mapping[:, :R]


# --------------------------------------------------------------------------
# CIGAR-run emission (the aligner's extension path)
#
# The traceback already walks the alignment, so these variants run the
# exact run-length state machine the host converter would (mapcig.cpp)
# DURING the walk and ship only the (B, MAXR) run list to the host: one
# packed uint16 per CIGAR run instead of one int16 per draft column.
#
# Runs are emitted in TRACEBACK order (reverse of the final CIGAR): each
# iteration emits the consumed LEFT run (a D op) first, then merges the
# UP/DIAG act into the open M/I run.  The host reverses.  Encoding:
# ``(len - 1) << 2 | op`` with op M=0, I=1, D=2 (haslr_tpu.core.cigar) —
# len <= 16384 fits 16 bits for every bucket.  Reads with more than MAXR
# runs report their true count so the caller can fall back; no run list
# is silently truncated into a wrong CIGAR.
# --------------------------------------------------------------------------


def _runs_emit(runs, n_runs, lane_m, cond, op, length):
    """Append ``(op, length)`` at slot ``n_runs`` where ``cond`` (full-
    width lane select; slots beyond MAXR drop, the count keeps growing so
    overflow is detectable)."""
    val = ((length - 1) << 2) | op
    runs = jnp.where((lane_m == n_runs) & cond, val, runs)
    return runs, n_runs + cond


def _rowscan_cigar_inner(reads, r_lens, drafts, d_lens, R, D, W, match,
                         mismatch, gap, MAXR):
    """XLA DP + traceback emitting CIGAR runs; returns
    ``(runs (B, MAXR) int32, n_runs (B,) int32)``."""
    B = reads.shape[0]
    dirs = _rowscan_dirs_inner(reads, r_lens, drafts, d_lens, R, D, W,
                               match, mismatch, gap)
    base = jnp.asarray(row_bases(R, D, W))
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    lane_m = jnp.arange(MAXR, dtype=jnp.int32)[None, :]
    zero_b = (r_lens.astype(jnp.int32) * 0)[:, None]

    def step(carry, r):
        i, j, cur_op, cur_len, n_runs, runs = carry
        active = i == r
        b_r = base[r]
        lane = j - b_r
        in_band = (lane >= 0) & (lane < W)
        row = dirs[r].astype(jnp.int32)
        val_k = jnp.where(row != LEFT, (lanes << 2) | row, -1)
        pm = jax.lax.associative_scan(jnp.maximum, val_k, axis=1)
        picked = jnp.take_along_axis(
            pm, jnp.clip(lane, 0, W - 1)[:, None], axis=1
        )[:, 0]
        forced = ~in_band | (picked < 0)
        d = jnp.where(forced, jnp.int32(UP), picked & 3)
        lane_f = jnp.where(forced, lane, picked >> 2)
        jp = b_r + lane_f
        is_diag = (active & (d == DIAG))[:, None]
        act = active[:, None]
        len_d = (j - jp)[:, None]
        emit_d = act & (len_d > 0)
        flush1 = emit_d & (cur_len > 0)
        runs, n_runs = _runs_emit(runs, n_runs, lane_m, flush1, cur_op,
                                  cur_len)
        runs, n_runs = _runs_emit(runs, n_runs, lane_m, emit_d,
                                  jnp.int32(LEFT), len_d)
        cur_len = jnp.where(emit_d, 0, cur_len)
        act_op = jnp.where(is_diag, jnp.int32(DIAG), jnp.int32(UP))
        same = act & (cur_len > 0) & (cur_op == act_op)
        flush2 = act & (cur_len > 0) & (cur_op != act_op)
        runs, n_runs = _runs_emit(runs, n_runs, lane_m, flush2, cur_op,
                                  cur_len)
        cur_len = jnp.where(act, jnp.where(same, cur_len + 1, 1), cur_len)
        cur_op = jnp.where(act, act_op, cur_op)
        i = i - active
        j = jnp.where(is_diag[:, 0], jp - 1, jnp.where(active, jp, j))
        return (i, j, cur_op, cur_len, n_runs, runs), None

    runs0 = jnp.full((B, MAXR), 0, jnp.int32) + zero_b
    rs_seq = jnp.arange(R, 0, -1, dtype=jnp.int32)
    (_, j, cur_op, cur_len, n_runs, runs), _ = jax.lax.scan(
        step,
        (
            r_lens.astype(jnp.int32),
            d_lens.astype(jnp.int32),
            jnp.full((B, 1), -1, jnp.int32) + zero_b,
            jnp.zeros((B, 1), jnp.int32) + zero_b,
            jnp.zeros((B, 1), jnp.int32) + zero_b,
            runs0,
        ),
        rs_seq,
    )
    runs, n_runs = _runs_emit(runs, n_runs, lane_m, cur_len > 0, cur_op,
                              cur_len)
    runs, n_runs = _runs_emit(runs, n_runs, lane_m, (j > 0)[:, None],
                              jnp.int32(LEFT), j[:, None])
    return runs, n_runs[:, 0]


def rowscan_mapping(reads, r_lens, drafts, d_lens, R, D, W, match,
                    mismatch, gap):
    """Production row-scan DP + traceback (traceable): the (B, R) int32
    mapping from the CUDA kernel or the XLA scan, by :func:`use_kernel`."""
    if use_kernel(R, D, W):
        from haslr_tpu.kernels import rowscan_gpu

        return rowscan_gpu.mapping(
            reads, r_lens, drafts, d_lens, row_bases(R, D, W), match,
            mismatch, gap,
        )
    return _rowscan_mapping_inner(reads, r_lens, drafts, d_lens, R, D, W,
                                  match, mismatch, gap)


def rowscan_cigar(reads, r_lens, drafts, d_lens, R, D, W, match, mismatch,
                  gap, MAXR):
    """Production row-scan DP + CIGAR-run traceback (traceable):
    ``(runs (B, MAXR) int32, n_runs (B,) int32)``, by :func:`use_kernel`."""
    if use_kernel(R, D, W):
        from haslr_tpu.kernels import rowscan_gpu

        return rowscan_gpu.cigar(
            reads, r_lens, drafts, d_lens, row_bases(R, D, W), match,
            mismatch, gap, MAXR,
        )
    return _rowscan_cigar_inner(reads, r_lens, drafts, d_lens, R, D, W,
                                match, mismatch, gap, MAXR)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10))
def _cigar_device(reads, r_lens, drafts, d_lens, R, D, W, match, mismatch,
                  gap, MAXR):
    runs, n_runs = rowscan_cigar(reads, r_lens, drafts, d_lens, R, D, W,
                                 match, mismatch, gap, MAXR)
    # (len - 1) << 2 | op <= 65535 for every bucket: ship uint16
    return runs.astype(jnp.uint16), n_runs


def default_maxr(R: int) -> int:
    """Run-list slots per read: enough for every read the extension's
    error rates produce; longer lists overflow to a host realignment."""
    return max(128, R // 4)


def cigar_runs_device_raw(reads, r_lens, drafts, d_lens, W=128, match=2,
                          mismatch=-4, gap=-2, maxr=None):
    """Device-resident align + CIGAR-run traceback; returns DEVICE arrays
    ``(runs (B, MAXR) uint16, n_runs (B,) int32)`` — the D2H payload is
    one packed run per CIGAR op instead of one int16 per draft column."""
    R = reads.shape[1]
    D = drafts.shape[1]
    return _cigar_device(
        jnp.asarray(reads),
        jnp.asarray(r_lens, dtype=jnp.int32),
        jnp.asarray(drafts),
        jnp.asarray(d_lens, dtype=jnp.int32),
        R, D, W, match, mismatch, gap, maxr or default_maxr(R),
    )


@functools.lru_cache(maxsize=None)
def _make_sharded_cigar(mesh, R, D, W, match, mismatch, gap, maxr):
    """shard_mapped CIGAR-run extraction over the mesh's ``dp`` axis
    (rows independent, no collective; runs come back row-sharded)."""
    from jax.sharding import PartitionSpec as P

    def _one(reads, r_lens, drafts, d_lens):
        return _cigar_device(
            reads, r_lens, drafts, d_lens, R, D, W, match, mismatch, gap,
            maxr,
        )

    sm = jax.shard_map(
        _one,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp")),
        check_vma=True,
    )
    return jax.jit(sm)


def cigar_runs_device_sharded(reads, r_lens, drafts, d_lens, mesh, W=128,
                              match=2, mismatch=-4, gap=-2, maxr=None):
    """Data-parallel :func:`cigar_runs_device_raw` over a ``dp`` mesh
    (B must divide evenly; pad with zero-length rows)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    B, R = reads.shape
    D = drafts.shape[1]
    n_dev = int(mesh.devices.size)
    assert B % n_dev == 0
    fn = _make_sharded_cigar(mesh, R, D, W, match, mismatch, gap,
                             maxr or default_maxr(R))
    sh = NamedSharding(mesh, P("dp"))
    return fn(
        jax.device_put(np.ascontiguousarray(reads), sh),
        jax.device_put(np.ascontiguousarray(r_lens, np.int32), sh),
        jax.device_put(np.ascontiguousarray(drafts), sh),
        jax.device_put(np.ascontiguousarray(d_lens, np.int32), sh),
    )
