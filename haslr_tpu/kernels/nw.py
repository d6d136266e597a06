"""Batched banded Needleman-Wunsch alignment (anti-diagonal wavefront).

The consensus hot loop of the reference is SPOA's SIMD sequence-to-graph
alignment, one window at a time on one CPU core (``Assemble.cpp:499-555``).
The formulation here instead aligns a whole *batch* of reads to their
window drafts in lockstep:

- DP state lives in ``(B, W)`` arrays — B reads, W band lanes — advanced
  over ``T = R + D`` anti-diagonals by a ``lax.scan``.  Every step is a
  handful of elementwise ops; there is no per-read control flow (per-read
  lengths are handled by masks).
- The band of width W follows the main diagonal; per-step lane shifts are
  precomputed host-side from the band base offsets.
- Direction bits (diag/up/left) stream to the output; traceback runs
  lockstep-batched on host (:func:`traceback_batch`), producing for every
  read base its aligned draft position (or its insertion anchor).

Scores are the reference's SPOA parameters (match 5, mismatch -4, linear
gap -8, global alignment).  Reads whose length differs from their draft's
by ~W/2 or more cannot reach the final DP cell inside the band and must be
filtered by the caller.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.int32(-(10**8))
DIAG, UP, LEFT = 0, 1, 2

# which DP formulation the production align paths use:
#   "rowscan"   — R row steps, closed-form in-row insertion chains, half
#                 the cells (kernels/nw_rowscan.py; the default)
#   "wavefront" — R+D anti-diagonal steps (this module; kept as the
#                 cross-check oracle, selectable per call)
# Resolved to a static jit argument at every non-jitted entry point, so
# flipping it mid-process affects subsequent calls (tests rely on this).
ENGINE = "rowscan"


def _resolve_engine(engine):
    return ENGINE if engine is None else engine


def band_bases(R: int, D: int, W: int) -> np.ndarray:
    """Lane-0 draft position per anti-diagonal t in [0, R+D], centered on
    the main diagonal, monotone with steps in {0, 1}."""
    t = np.arange(R + D + 1, dtype=np.int64)
    center = (t * D) // (R + D)
    hi = max(0, D - W + 1)
    base = np.clip(center - W // 2, 0, hi)
    base = np.maximum.accumulate(base)  # monotone (clip is, but be safe)
    return base.astype(np.int32)


def _shift_lanes(x, off):
    """x[..., k + off] with -inf fill; ``off`` is a traced scalar in [-1, 2]."""
    B, W = x.shape
    pad = jnp.full((B, 2), NEG, dtype=x.dtype)
    xp = jnp.concatenate([pad[:, :1], x, pad], axis=1)  # lanes -1 .. W+1
    return jax.lax.dynamic_slice_in_dim(xp, off + 1, W, axis=1)


def _nw_scan_inner(reads, r_lens, drafts, d_lens, R, D, W, match, mismatch,
                   gap):
    """Banded DP over anti-diagonals; returns dirs[T+1, B, W] uint8."""
    B = reads.shape[0]
    T = R + D
    base = jnp.asarray(band_bases(R, D, W))
    lanes = jnp.arange(W, dtype=jnp.int32)

    # derive the carries from a (possibly device-varying) input so the
    # scan types correctly under shard_map's varying-mask analysis
    zero_b = (r_lens.astype(jnp.int32) * 0)[:, None]
    h_init = jnp.full((B, W), NEG, dtype=jnp.int32) + zero_b
    h0 = h_init.at[:, 0].set(0)  # t=0: cell (0, 0) at lane 0 (base[0] == 0)
    reads_p = jnp.concatenate(
        [reads, jnp.full((B, 1), 4, dtype=reads.dtype)], axis=1
    )
    drafts_p = jnp.concatenate(
        [drafts, jnp.full((B, 1), 4, dtype=drafts.dtype)], axis=1
    )

    def step(carry, t):
        h_prev2, h_prev1 = carry  # diagonals t-2 and t-1
        b_t = base[t]
        s1 = b_t - base[t - 1]
        s2 = b_t - base[t - 2]
        j = b_t + lanes                       # (W,) draft index per lane
        i = t - j                             # (W,) read index per lane
        up = _shift_lanes(h_prev1, s1)        # (i-1, j)
        left = _shift_lanes(h_prev1, s1 - 1)  # (i, j-1)
        diag = _shift_lanes(h_prev2, s2 - 1)  # (i-1, j-1)
        rb = jnp.take(reads_p, jnp.clip(i - 1, 0, R), axis=1)   # (B, W)
        db = jnp.take(drafts_p, jnp.clip(j - 1, 0, D), axis=1)
        sub = jnp.where(rb == db, match, mismatch).astype(jnp.int32)
        i_b, j_b = i[None, :], j[None, :]
        rl, dl = r_lens[:, None], d_lens[:, None]
        cell_valid = (i_b >= 0) & (i_b <= rl) & (j_b >= 0) & (j_b <= dl)
        cand_d = jnp.where((i_b >= 1) & (j_b >= 1), diag + sub, NEG)
        cand_u = jnp.where(i_b >= 1, up + gap, NEG)
        cand_l = jnp.where(j_b >= 1, left + gap, NEG)
        h = jnp.maximum(cand_d, jnp.maximum(cand_u, cand_l))
        d = jnp.where(
            h == cand_d,
            jnp.uint8(DIAG),
            jnp.where(h == cand_u, jnp.uint8(UP), jnp.uint8(LEFT)),
        )
        h = jnp.where(cell_valid, h, NEG)
        return (h_prev1, h), d

    ts = jnp.arange(1, T + 1, dtype=jnp.int32)
    _, dirs = jax.lax.scan(step, (h_init, h0), ts)
    return jnp.concatenate(
        [jnp.zeros((1, B, W), dtype=jnp.uint8), dirs], axis=0
    )


_nw_scan = functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9))(
    _nw_scan_inner
)


def nw_scores(reads, r_lens, drafts, d_lens, W=128, match=5, mismatch=-4,
              gap=-8):
    """Score-only banded NW (no direction tensor) — traceable/shardable.

    Same DP as :func:`_nw_scan` but carries only two H rows and captures
    each read's final-cell score on the fly; usable inside jit/shard_map
    for the distributed consensus step (B can be a sharded axis).
    """
    R = reads.shape[1]
    D = drafts.shape[1]
    B = reads.shape[0]
    T = R + D
    base = jnp.asarray(band_bases(R, D, W))
    lanes = jnp.arange(W, dtype=jnp.int32)
    r_lens = r_lens.astype(jnp.int32)
    d_lens = d_lens.astype(jnp.int32)
    # derive the initial carries from a (possibly device-varying) input so
    # this function also types correctly under shard_map (vma rules)
    zero_b = (r_lens * 0)[:, None]
    h_init = jnp.full((B, W), NEG, dtype=jnp.int32) + zero_b
    h0 = h_init.at[:, 0].set(0)
    reads_p = jnp.concatenate(
        [reads, jnp.full((B, 1), 4, dtype=reads.dtype)], axis=1
    )
    drafts_p = jnp.concatenate(
        [drafts, jnp.full((B, 1), 4, dtype=drafts.dtype)], axis=1
    )

    def step(carry, t):
        h_prev2, h_prev1, best = carry
        b_t = base[t]
        s1 = b_t - base[t - 1]
        s2 = b_t - base[t - 2]
        j = b_t + lanes
        i = t - j
        up = _shift_lanes(h_prev1, s1)
        left = _shift_lanes(h_prev1, s1 - 1)
        diag = _shift_lanes(h_prev2, s2 - 1)
        rb = jnp.take(reads_p, jnp.clip(i - 1, 0, R), axis=1)
        db = jnp.take(drafts_p, jnp.clip(j - 1, 0, D), axis=1)
        sub = jnp.where(rb == db, match, mismatch).astype(jnp.int32)
        i_b, j_b = i[None, :], j[None, :]
        rl, dl = r_lens[:, None], d_lens[:, None]
        cell_valid = (i_b >= 0) & (i_b <= rl) & (j_b >= 0) & (j_b <= dl)
        h = jnp.maximum(
            jnp.where((i_b >= 1) & (j_b >= 1), diag + sub, NEG),
            jnp.maximum(
                jnp.where(i_b >= 1, up + gap, NEG),
                jnp.where(j_b >= 1, left + gap, NEG),
            ),
        )
        h = jnp.where(cell_valid, h, NEG)
        # capture final-cell scores as their diagonals pass by
        at_final = (t == r_lens + d_lens)
        lane_f = jnp.clip(d_lens - b_t, 0, W - 1)
        val = jnp.take_along_axis(h, lane_f[:, None], axis=1)[:, 0]
        best = jnp.where(at_final, val, best)
        return (h_prev1, h, best), None

    ts = jnp.arange(1, T + 1, dtype=jnp.int32)
    (_, _, best), _ = jax.lax.scan(
        step, (h_init, h0, jnp.full((B,), NEG, jnp.int32) + r_lens * 0), ts
    )
    # degenerate empty pairs score 0
    return jnp.where((r_lens == 0) & (d_lens == 0), 0, best)


def _align_mapping_inner(reads, r_lens, drafts, d_lens, R, D, W, match,
                         mismatch, gap, engine="wavefront"):
    """DP + traceback entirely on device; returns mapping (B, R).

    The direction tensor never leaves the device.  ``engine`` selects the
    DP formulation (see :data:`ENGINE`); the row scan applies only where
    its band advances by at most one column per row
    (``nw_rowscan.rowscan_supported``) and the wavefront serves the
    other shapes.
    """
    from haslr_tpu.kernels import nw_rowscan as rs

    B = reads.shape[0]
    T = R + D
    # int16 halves the mapping's size; big drafts need int32 (the
    # insertion encoding -(j+2) must hold -(D+2))
    out_dtype = jnp.int16 if D <= 32000 else jnp.int32
    if engine == "rowscan" and rs.rowscan_supported(R, D, W):
        mapping = rs.rowscan_mapping(
            reads, r_lens, drafts, d_lens, R, D, W, match, mismatch, gap,
        )
        return mapping.astype(out_dtype)
    dirs = _nw_scan_inner(reads, r_lens, drafts, d_lens, R, D, W, match,
                          mismatch, gap)
    base = jnp.asarray(band_bases(R, D, W))
    bidx = jnp.arange(B)

    def step(carry, _):
        i, j, mapping = carry
        active = (i > 0) | (j > 0)
        t = i + j
        lane = j - base[t]
        in_band = (lane >= 0) & (lane < W) & active
        d = dirs[t, bidx, jnp.clip(lane, 0, W - 1)]
        d = jnp.where(in_band, d, jnp.uint8(LEFT))
        d = jnp.where(active & (i == 0), jnp.uint8(LEFT), d)
        d = jnp.where(active & (j == 0), jnp.uint8(UP), d)
        is_diag = active & (d == DIAG)
        is_up = active & (d == UP)
        is_left = active & (d == LEFT)
        write = is_diag | is_up
        val = jnp.where(is_diag, j - 1, -(j + 2)).astype(jnp.int32)
        idx = jnp.where(write, i - 1, R)  # non-writers hit the dump slot
        mapping = mapping.at[bidx, idx].set(val)
        i = i - (is_diag | is_up)
        j = j - (is_diag | is_left)
        return (i, j, mapping), None

    mapping0 = jnp.full((B, R + 1), -1, jnp.int32) + (
        r_lens.astype(jnp.int32) * 0
    )[:, None]
    (i, j, mapping), _ = jax.lax.scan(
        step,
        (r_lens.astype(jnp.int32), d_lens.astype(jnp.int32), mapping0),
        None,
        length=T,
    )
    return mapping[:, :R].astype(out_dtype)


_align_mapping = functools.partial(
    jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10)
)(_align_mapping_inner)


def align_mapping_device_raw(
    reads: np.ndarray,
    r_lens: np.ndarray,
    drafts: np.ndarray,
    d_lens: np.ndarray,
    W: int = 128,
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
):
    """Device-resident align + traceback; returns the (B, R) mapping as a
    DEVICE array (see :func:`traceback_batch` for the encoding)."""
    R = reads.shape[1]
    D = drafts.shape[1]
    return _align_mapping(
        jnp.asarray(reads),
        jnp.asarray(r_lens, dtype=jnp.int32),
        jnp.asarray(drafts),
        jnp.asarray(d_lens, dtype=jnp.int32),
        R, D, W, match, mismatch, gap, _resolve_engine(None),
    )


def align_mapping_device(
    reads: np.ndarray,
    r_lens: np.ndarray,
    drafts: np.ndarray,
    d_lens: np.ndarray,
    W: int = 128,
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
) -> np.ndarray:
    """Host-array wrapper around :func:`align_mapping_device_raw`."""
    return np.asarray(
        align_mapping_device_raw(
            reads, r_lens, drafts, d_lens, W, match, mismatch, gap
        )
    )


@functools.lru_cache(maxsize=None)
def _make_sharded_align(mesh, R, D, W, match, mismatch, gap, engine):
    """shard_mapped batched align over the mesh's ``dp`` axis: rows are
    independent, so the batch simply splits across devices (no collective)
    and the mapping comes back row-sharded; the scan carries anchor to
    device-varying inputs so the static VMA checker passes."""
    from jax.sharding import PartitionSpec as P

    def _one(reads, r_lens, drafts, d_lens):
        return _align_mapping_inner(
            reads, r_lens, drafts, d_lens, R, D, W, match, mismatch, gap,
            engine,
        )

    sm = jax.shard_map(
        _one,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=P("dp"),
        check_vma=True,
    )
    return jax.jit(sm)


def align_mapping_device_sharded(
    reads, r_lens, drafts, d_lens, mesh, W=128, match=5, mismatch=-4,
    gap=-8,
):
    """Like :func:`align_mapping_device_raw` but data-parallel over a
    ``dp`` mesh (B must divide evenly; pad with zero-length rows)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    B, R = reads.shape
    D = drafts.shape[1]
    n_dev = int(mesh.devices.size)
    assert B % n_dev == 0
    fn = _make_sharded_align(mesh, R, D, W, match, mismatch, gap,
                             _resolve_engine(None))
    sh = NamedSharding(mesh, P("dp"))
    return fn(
        jax.device_put(np.ascontiguousarray(reads), sh),
        jax.device_put(np.ascontiguousarray(r_lens, np.int32), sh),
        jax.device_put(np.ascontiguousarray(drafts), sh),
        jax.device_put(np.ascontiguousarray(d_lens, np.int32), sh),
    )


def banded_nw_batch(
    reads: np.ndarray,
    r_lens: np.ndarray,
    drafts: np.ndarray,
    d_lens: np.ndarray,
    W: int = 128,
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
):
    """Align each read to its draft.  Returns ``(dirs, base)``: the
    (T+1, B, W) direction tensor (numpy uint8) and the band offsets, ready
    for :func:`traceback_batch`."""
    R = reads.shape[1]
    D = drafts.shape[1]
    dirs = _nw_scan(
        jnp.asarray(reads),
        jnp.asarray(r_lens, dtype=jnp.int32),
        jnp.asarray(drafts),
        jnp.asarray(d_lens, dtype=jnp.int32),
        R, D, W, match, mismatch, gap,
    )
    return np.asarray(dirs), band_bases(R, D, W)


def traceback_batch(
    dirs: np.ndarray,
    base: np.ndarray,
    r_lens: np.ndarray,
    d_lens: np.ndarray,
    R_pad: int,
) -> np.ndarray:
    """Lockstep-batched traceback.

    Returns ``mapping`` (B, R_pad) int32: for read base index i,
      - ``mapping[b, i] = j``      — base aligned to draft position j;
      - ``mapping[b, i] = -(a+3)`` — base inserted after draft position a
        (a = -1 for insertions before the draft start);
      - ``-1`` marks unused positions (i >= r_len).

    All reads step together: each iteration of the Python loop advances
    every active read by one traceback move via vectorized gathers, so the
    loop runs O(R + D) times regardless of batch size.
    """
    Bn = len(r_lens)
    W = dirs.shape[2]
    mapping = np.full((Bn, R_pad), -1, dtype=np.int32)
    i = r_lens.astype(np.int64).copy()
    j = d_lens.astype(np.int64).copy()
    bidx = np.arange(Bn)
    active = (i > 0) | (j > 0)
    while active.any():
        t = i + j
        lane = j - base[t]
        in_band = (lane >= 0) & (lane < W) & active
        d = np.full(Bn, LEFT, dtype=np.uint8)
        d[in_band] = dirs[t[in_band], bidx[in_band], lane[in_band]]
        d = np.where(active & (i == 0), LEFT, d)
        d = np.where(active & (j == 0), UP, d)
        is_diag = active & (d == DIAG)
        is_up = active & (d == UP)
        is_left = active & (d == LEFT)
        sel = is_diag
        mapping[bidx[sel], i[sel] - 1] = (j[sel] - 1).astype(np.int32)
        sel = is_up
        mapping[bidx[sel], i[sel] - 1] = (-(j[sel] + 2)).astype(np.int32)
        i -= is_diag | is_up
        j -= is_diag | is_left
        active = (i > 0) | (j > 0)
    return mapping
