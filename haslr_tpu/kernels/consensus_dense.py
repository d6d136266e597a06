"""Fully device-resident multi-round window consensus.

The production device consensus engine (replaces the reference's
per-window SPOA loop, ``Assemble.cpp:479-605``).  The round-1 engine
(:mod:`haslr_tpu.kernels.consensus`) re-bucketed windows on host between
polish rounds and shipped padded ``(B, S)`` read/draft tensors to the
device every round.  This engine instead runs the WHOLE consensus —
unpacking, draft selection, both polish rounds (banded-NW align + pileup
vote + draft compaction) — in ONE jit computation per length bucket, so
the host touches each bucket twice (one upload, one download):

- input: one flat concatenated uint8 code array (2-bit alphabet) plus
  offsets/lengths/window ids — a few hundred KB for thousands of windows,
  transferred once;
- on device: reads and drafts are gathered into padded ``(B, S)`` /
  ``(N, S)`` tensors; each round aligns every read to its window's current
  draft (the row-scan DP: CUDA kernel or XLA scan by bucket shape,
  :mod:`haslr_tpu.kernels.nw_rowscan`), scatters base/coverage/insertion
  votes into dense per-window tables, votes, and COMPACTS the voted slots
  into the next round's draft tensor — drafts never leave the device
  between rounds;
- output: one packed ``(N, S/4)`` 2-bit draft tensor + lengths — a single
  small device->host transfer for the whole batch.

Vote semantics are identical to the host ``_Pileup``/``DevicePileup``
engines (same emit rules and tie-breaks); band-incompatible reads
(``|r_len - d_len| >= W/2 - 4``) are masked out per round exactly like the
round-1 host re-bucketing did.  Windows whose consensus would outgrow the
bucket are clipped at ``S`` and reported via :func:`dense_consensus`'s
``clipped`` counter (the caller logs a warning instead of silence).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from haslr_tpu.kernels import nw
from haslr_tpu.kernels.nw import _align_mapping_inner

DUMP = np.int32(1 << 30)

BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def _bucket_size(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def _band_width(S: int) -> int:
    if S <= 1024:
        return 128
    if S <= 2048:
        return 256
    return 512


def _pad_to(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def _pad_shape(n: int, floor: int) -> int:
    """Next power of two (>= floor): keeps the set of compiled jit shapes
    small across assemblies (each new shape is a compile)."""
    p = floor
    while p < n:
        p *= 2
    return p


def _unpack_rows(flat, offsets, lens, S):
    """Gather ragged rows out of the 2-BIT-PACKED flat code array into
    (n, S) uint8, padded with 4 (the non-base sentinel).

    ``flat`` holds 4 codes/byte LSB-first (``kmer_stream.pack2`` layout);
    packing quarters the host->device transfer.  The gather count is
    unchanged — only the byte index and a shift differ."""
    col = jnp.arange(S, dtype=jnp.int32)[None, :]
    idx = offsets[:, None] + col
    valid = col < lens[:, None]
    idx = jnp.clip(idx, 0, flat.shape[0] * 4 - 1)
    byte = flat[idx >> 2]
    vals = (byte >> ((idx & 3).astype(jnp.uint8) << 1)) & 3
    return jnp.where(valid, vals, jnp.uint8(4))


def _scatter_votes(mapping, reads, r_lens, win_idx, ok, N, S):
    """Dense vote scatter: counts (N*S, 4), cov_diff/ins (N*(S+1), ...).

    Same accumulation semantics as ``pileup._scatter_chunk_inner`` but with
    the stride-S dense layout and an ``ok`` row mask (band-incompatible
    reads drop out)."""
    B = mapping.shape[0]
    Sr = mapping.shape[1]
    col = jnp.arange(Sr, dtype=jnp.int32)[None, :]
    in_len = col < r_lens[:, None]
    m = mapping.astype(jnp.int32)
    aligned = (m >= 0) & in_len & ok[:, None]
    rbase = reads.astype(jnp.int32) & 3
    woff1 = jnp.where(ok, win_idx * (S + 1), DUMP)

    cov_diff = jnp.zeros(N * (S + 1) + 1, jnp.int32)
    n_reads = jnp.zeros(N, jnp.int32)

    any_aligned = aligned.any(axis=1)
    big = jnp.where(aligned, m, jnp.int32(1 << 29))
    small = jnp.where(aligned, m, jnp.int32(-1))
    jmin = big.min(axis=1)
    jmax = small.max(axis=1)
    start_t = jnp.where(any_aligned, woff1 + jmin, DUMP)
    end_t = jnp.where(any_aligned, woff1 + jmax + 1, DUMP)
    cov_diff = cov_diff.at[start_t].add(1, mode="drop")
    cov_diff = cov_diff.at[end_t].add(-1, mode="drop")
    n_reads = n_reads.at[jnp.where(any_aligned, win_idx, DUMP)].add(
        1, mode="drop"
    )

    ins = (m <= -2) & in_len & ok[:, None]
    anchors = -m - 3
    prev_ins = jnp.concatenate(
        [jnp.zeros((B, 1), bool), ins[:, :-1]], axis=1
    )
    prev_anchor = jnp.concatenate(
        [jnp.full((B, 1), -9, jnp.int32), anchors[:, :-1]], axis=1
    )
    start = ins & (~prev_ins | (anchors != prev_anchor))
    idx = jnp.broadcast_to(col, (B, Sr))
    last_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(start, idx, -1), axis=1
    )
    rank = idx - last_start
    row_ok = any_aligned[:, None]
    # ONE scatter builds base counts AND both insertion ranks: a read
    # position is EITHER an aligned base vote OR a (rank<=1) insertion
    # vote OR nothing, so the three original B*S scatters collapse into
    # one over a combined per-window table laid out as
    # [counts (S rows) | ins (S+1 rows x 2 ranks)], stride 3S+2 rows
    sel12 = ins & (rank <= 1) & row_ok
    win = win_idx[:, None]
    stride = 3 * S + 2
    cell_cnt = win * stride + m
    cell_ins = (
        win * stride + S + jnp.clip(anchors + 1, 0, S) * 2 + rank
    )
    cell = jnp.where(
        aligned, cell_cnt, jnp.where(sel12, cell_ins, DUMP)
    )
    table = (
        jnp.zeros((N * stride, 4), jnp.int32)
        .at[cell.reshape(-1), rbase.reshape(-1)]
        .add(1, mode="drop")
        .reshape(N, stride, 4)
    )
    counts = table[:, :S].reshape(N * S, 4)
    ins12 = table[:, S:].reshape(N, S + 1, 2, 4)
    ins1 = ins12[:, :, 0].reshape(N * (S + 1), 4)
    ins2 = ins12[:, :, 1].reshape(N * (S + 1), 4)
    return counts, cov_diff, ins1, ins2, n_reads


INVALID_KEY = np.int32(2**31 - 1)


def _scatter_votes_sorted(mapping, reads, r_lens, win_idx, ok, N, S):
    """Same tables as :func:`_scatter_votes`, built sort-first.

    A scatter-add with duplicate unsorted indices can serialize; the
    base/insertion votes here are 3 such scatters of B*S elements each.
    Instead every cell is encoded as ONE combined int32 key
    (base votes: ``(win*S + pos)*4 + base``; insertion votes:
    ``4*N*S + ((win*(S+1) + q)*2 + rank)*4 + base``; everything else:
    INVALID), the keys are sorted once, runs are length-counted by
    position difference, and the per-run totals land in the dense tables
    through scatters whose indices are ASCENDING (``indices_are_sorted``)
    — the same sort→RLE→sorted-scatter shape the k-mer counter uses.
    The small coverage/read-count scatters (O(B)) stay direct."""
    B = mapping.shape[0]
    Sr = mapping.shape[1]
    col = jnp.arange(Sr, dtype=jnp.int32)[None, :]
    in_len = col < r_lens[:, None]
    m = mapping.astype(jnp.int32)
    aligned = (m >= 0) & in_len & ok[:, None]
    rbase = reads.astype(jnp.int32) & 3
    assert 12 * N * (S + 1) < 2**31 - 2, "combined vote key overflows int32"

    # --- per-cell combined key ------------------------------------------
    win = win_idx[:, None]
    key_cnt = (win * S + jnp.clip(m, 0, S - 1)) * 4 + rbase

    ins = (m <= -2) & in_len & ok[:, None]
    anchors = -m - 3
    prev_ins = jnp.concatenate(
        [jnp.zeros((B, 1), bool), ins[:, :-1]], axis=1
    )
    prev_anchor = jnp.concatenate(
        [jnp.full((B, 1), -9, jnp.int32), anchors[:, :-1]], axis=1
    )
    start = ins & (~prev_ins | (anchors != prev_anchor))
    idx = jnp.broadcast_to(col, (B, Sr))
    last_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(start, idx, -1), axis=1
    )
    rank = idx - last_start

    any_aligned = aligned.any(axis=1)
    row_ok = any_aligned[:, None]
    ins_sel = ins & (rank <= 1) & row_ok
    q = jnp.clip(anchors + 1, 0, S)
    key_ins = (
        4 * N * S + ((win * (S + 1) + q) * 2 + rank) * 4 + rbase
    )
    key = jnp.where(
        aligned, key_cnt, jnp.where(ins_sel, key_ins, INVALID_KEY)
    )

    # --- sort + run-length count ----------------------------------------
    M = B * Sr
    ks = jnp.sort(key.reshape(-1))
    validk = ks != INVALID_KEY
    n_valid = jnp.sum(validk.astype(jnp.int32))
    new = jnp.concatenate(
        [jnp.ones(1, bool), ks[1:] != ks[:-1]]
    ) & validk
    starts = jnp.nonzero(new, size=M, fill_value=M)[0]
    n_runs = jnp.sum(new.astype(jnp.int32))
    live = jnp.arange(M, dtype=jnp.int32) < n_runs
    next_start = jnp.concatenate(
        [starts[1:], jnp.full(1, M, starts.dtype)]
    )
    next_start = jnp.minimum(next_start.astype(jnp.int32), n_valid)
    run_cnt = jnp.where(
        live, next_start - starts.astype(jnp.int32), 0
    )
    run_key = ks[jnp.minimum(starts, M - 1)]

    # --- place runs into the dense tables (ascending indices) -----------
    split = 4 * N * S
    is_cnt = live & (run_key < split)
    counts = (
        jnp.zeros(N * S * 4, jnp.int32)
        .at[jnp.where(is_cnt, run_key, np.int32(2**31 - 2))]
        .add(run_cnt, mode="drop", indices_are_sorted=True)
        .reshape(N * S, 4)
    )
    rel = run_key - split
    is_ins = live & (run_key >= split) & (run_key != INVALID_KEY)
    i_cell = (rel >> 3) * 4 + (rel & 3)
    r1 = is_ins & (((rel >> 2) & 1) == 0)
    r2 = is_ins & (((rel >> 2) & 1) == 1)
    ins1 = (
        jnp.zeros(N * (S + 1) * 4, jnp.int32)
        .at[jnp.where(r1, i_cell, np.int32(2**31 - 2))]
        .add(run_cnt, mode="drop", indices_are_sorted=True)
        .reshape(N * (S + 1), 4)
    )
    ins2 = (
        jnp.zeros(N * (S + 1) * 4, jnp.int32)
        .at[jnp.where(r2, i_cell, np.int32(2**31 - 2))]
        .add(run_cnt, mode="drop", indices_are_sorted=True)
        .reshape(N * (S + 1), 4)
    )

    # --- coverage span + read-count scatters (O(B), unchanged) ----------
    woff1 = jnp.where(ok, win_idx * (S + 1), DUMP)
    cov_diff = jnp.zeros(N * (S + 1) + 1, jnp.int32)
    big = jnp.where(aligned, m, jnp.int32(1 << 29))
    small = jnp.where(aligned, m, jnp.int32(-1))
    jmin = big.min(axis=1)
    jmax = small.max(axis=1)
    start_t = jnp.where(any_aligned, woff1 + jmin, DUMP)
    end_t = jnp.where(any_aligned, woff1 + jmax + 1, DUMP)
    cov_diff = cov_diff.at[start_t].add(1, mode="drop")
    cov_diff = cov_diff.at[end_t].add(-1, mode="drop")
    n_reads = jnp.zeros(N, jnp.int32).at[
        jnp.where(any_aligned, win_idx, DUMP)
    ].add(1, mode="drop")
    return counts, cov_diff, ins1, ins2, n_reads


def _scatter_votes_packed(mapping, reads, r_lens, win_idx, ok, N, S):
    """Same tables as :func:`_scatter_votes`, built with ONE big scatter.

    The direct path issues three B*S-element scatter-adds (base votes,
    ins1, ins2) — 3x the scatter traffic for mutually-exclusive events
    (each read position is EITHER an aligned base vote OR an insertion
    vote OR nothing).  Here every position contributes one (cell, value)
    pair to a single combined table: the cell encodes
    (window, position/anchor, vote kind, base-pair) and the value packs
    the base's count increment into the low or high 16 bits of the int32
    cell (``1 << 16*(base & 1)``), so four base counters live in two
    int32 cells.  Counts stay exact while every per-table count is
    <= 65535 — guaranteed because a window's support is bounded by the
    bucket batch (B <= 65536 rows; padded rows vote into a dump cell).
    The O(B) coverage/read-count scatters are unchanged."""
    B = mapping.shape[0]
    Sr = mapping.shape[1]
    col = jnp.arange(Sr, dtype=jnp.int32)[None, :]
    in_len = col < r_lens[:, None]
    m = mapping.astype(jnp.int32)
    aligned = (m >= 0) & in_len & ok[:, None]
    rbase = reads.astype(jnp.int32) & 3
    win = win_idx[:, None]

    # insertion runs + ranks (identical logic to _scatter_votes)
    ins = (m <= -2) & in_len & ok[:, None]
    anchors = -m - 3
    prev_ins = jnp.concatenate(
        [jnp.zeros((B, 1), bool), ins[:, :-1]], axis=1
    )
    prev_anchor = jnp.concatenate(
        [jnp.full((B, 1), -9, jnp.int32), anchors[:, :-1]], axis=1
    )
    start = ins & (~prev_ins | (anchors != prev_anchor))
    idx = jnp.broadcast_to(col, (B, Sr))
    last_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(start, idx, -1), axis=1
    )
    rank = idx - last_start
    any_aligned = aligned.any(axis=1)
    row_ok = any_aligned[:, None]
    ins_sel = ins & (rank <= 1) & row_ok

    # combined cell: [0, 2NS) base votes, [2NS, 2NS+4N(S+1)) ins votes
    hi = rbase >> 1
    cell_cnt = (win * S + jnp.clip(m, 0, S - 1)) * 2 + hi
    q = jnp.clip(anchors + 1, 0, S)
    cell_ins = (
        2 * N * S + ((win * (S + 1) + q) * 2 + rank) * 2 + hi
    )
    cell = jnp.where(
        aligned, cell_cnt, jnp.where(ins_sel, cell_ins, DUMP)
    )
    val = jnp.int32(1) << (16 * (rbase & 1))
    table = (
        jnp.zeros(2 * N * S + 4 * N * (S + 1), jnp.int32)
        .at[cell.reshape(-1)]
        .add(val.reshape(-1), mode="drop")
    )

    cnt2 = table[: 2 * N * S].reshape(N * S, 2)
    counts = jnp.stack(
        [
            cnt2[:, 0] & 0xFFFF,
            cnt2[:, 0] >> 16,
            cnt2[:, 1] & 0xFFFF,
            cnt2[:, 1] >> 16,
        ],
        axis=1,
    )
    ins_t = table[2 * N * S :].reshape(N * (S + 1), 2, 2)
    ins1 = jnp.stack(
        [
            ins_t[:, 0, 0] & 0xFFFF,
            ins_t[:, 0, 0] >> 16,
            ins_t[:, 0, 1] & 0xFFFF,
            ins_t[:, 0, 1] >> 16,
        ],
        axis=1,
    )
    ins2 = jnp.stack(
        [
            ins_t[:, 1, 0] & 0xFFFF,
            ins_t[:, 1, 0] >> 16,
            ins_t[:, 1, 1] & 0xFFFF,
            ins_t[:, 1, 1] >> 16,
        ],
        axis=1,
    )

    # coverage span + read-count scatters (O(B), unchanged)
    woff1 = jnp.where(ok, win_idx * (S + 1), DUMP)
    cov_diff = jnp.zeros(N * (S + 1) + 1, jnp.int32)
    big = jnp.where(aligned, m, jnp.int32(1 << 29))
    small = jnp.where(aligned, m, jnp.int32(-1))
    jmin = big.min(axis=1)
    jmax = small.max(axis=1)
    start_t = jnp.where(any_aligned, woff1 + jmin, DUMP)
    end_t = jnp.where(any_aligned, woff1 + jmax + 1, DUMP)
    cov_diff = cov_diff.at[start_t].add(1, mode="drop")
    cov_diff = cov_diff.at[end_t].add(-1, mode="drop")
    n_reads = jnp.zeros(N, jnp.int32).at[
        jnp.where(any_aligned, win_idx, DUMP)
    ].add(1, mode="drop")
    return counts, cov_diff, ins1, ins2, n_reads


_SCATTER_IMPLS = {
    "scatter": _scatter_votes,
    "sort": _scatter_votes_sorted,
    "packed": _scatter_votes_packed,
}


def _vote_compact(counts, cov_diff, ins1, ins2, n_reads, drafts, d_lens,
                  N, S):
    """Dense majority vote + on-device draft compaction.

    Emit rules and tie-breaks identical to ``pileup._vote_packed``; the
    kept slots (order: ins1[0], ins2[0], then per draft position p:
    base[p], ins1[p+1], ins2[p+1]) are compacted into the next (N, S)
    draft tensor with a cumsum-scatter.  Returns (new_drafts, new_d_lens,
    total_keep) where total_keep is the UNclipped per-window length."""
    counts4 = counts.reshape(N, S, 4)
    cov = jnp.cumsum(cov_diff[: N * (S + 1)].reshape(N, S + 1), axis=1)

    def best_and_sum(t4):
        """(argmax, max, sum) along the trailing base axis via explicit
        compares (three elementwise passes, no gather)."""
        c0, c1, c2, c3 = (t4[..., i] for i in range(4))
        m01 = jnp.maximum(c0, c1)
        m23 = jnp.maximum(c2, c3)
        best_cnt = jnp.maximum(m01, m23)
        # argmax tie-break = lowest index, matching jnp.argmax
        best = jnp.where(
            m01 >= m23,
            jnp.where(c0 >= c1, 0, 1),
            jnp.where(c2 >= c3, 2, 3),
        ).astype(jnp.int32)
        return best, best_cnt, c0 + c1 + c2 + c3

    base_best, base_best_cnt, base_sum = best_and_sum(counts4)
    draft_codes = (drafts.astype(jnp.int32) & 3)
    draft_cnt = (
        jnp.where(draft_codes == 0, counts4[..., 0], 0)
        + jnp.where(draft_codes == 1, counts4[..., 1], 0)
        + jnp.where(draft_codes == 2, counts4[..., 2], 0)
        + jnp.where(draft_codes == 3, counts4[..., 3], 0)
    )
    base_call = jnp.where(
        draft_cnt == base_best_cnt, draft_codes, base_best
    )
    emit_base = base_best_cnt > (cov[:, :S] - base_sum)

    ins1_4 = ins1.reshape(N, S + 1, 4)
    ins2_4 = ins2.reshape(N, S + 1, 4)
    ins1_call, _i1max, ins1_sum = best_and_sum(ins1_4)
    ins2_call, _i2max, ins2_sum = best_and_sum(ins2_4)
    # cov_prev[:, q] = cov[:, max(q-1, 0)] — a 1-lane shift, not a gather
    cov_prev = jnp.concatenate([cov[:, :1], cov[:, :-1]], axis=1)
    emit_i1 = ins1_sum * 2 > jnp.maximum(cov_prev, 1)
    emit_i2 = (ins2_sum * 2 > jnp.maximum(cov_prev, 1)) & emit_i1
    q = jnp.arange(S + 1, dtype=jnp.int32)[None, :]

    # slot interleave: [i1[0], i2[0], (base[p], i1[p+1], i2[p+1]) * S]
    pos_ok = q[:, :S] < d_lens[:, None]          # base slots: p < d_len
    q_ok = q <= d_lens[:, None]                  # ins slots: q <= d_len
    inner_vals = jnp.stack(
        [base_call, ins1_call[:, 1:], ins2_call[:, 1:]], axis=2
    ).reshape(N, 3 * S)
    inner_keep = jnp.stack(
        [
            emit_base & pos_ok,
            emit_i1[:, 1:] & q_ok[:, 1:],
            emit_i2[:, 1:] & q_ok[:, 1:],
        ],
        axis=2,
    ).reshape(N, 3 * S)
    vals = jnp.concatenate(
        [ins1_call[:, :1], ins2_call[:, :1], inner_vals], axis=1
    )
    keep = jnp.concatenate(
        [
            (emit_i1[:, :1] & q_ok[:, :1]),
            (emit_i2[:, :1] & q_ok[:, :1]),
            inner_keep,
        ],
        axis=1,
    )

    kcum = jnp.cumsum(keep.astype(jnp.int32), axis=1)
    pos = kcum - 1
    total_keep = kcum[:, -1]
    rows = jnp.arange(N, dtype=jnp.int32)[:, None]
    tgt = jnp.where(keep & (pos < S), rows * S + pos, DUMP)
    new_flat = jnp.full(N * S, 4, jnp.uint8)
    new_flat = new_flat.at[tgt.reshape(-1)].set(
        vals.astype(jnp.uint8).reshape(-1), mode="drop"
    )
    new_drafts = new_flat.reshape(N, S)
    new_d_lens = jnp.minimum(total_keep, S)

    # windows nobody voted on keep their draft
    quiet = (n_reads == 0)[:, None]
    new_drafts = jnp.where(quiet, drafts, new_drafts)
    new_d_lens = jnp.where(quiet[:, 0], d_lens, new_d_lens)
    total_keep = jnp.where(quiet[:, 0], d_lens, total_keep)
    return new_drafts, new_d_lens, total_keep


def _rounds_impl(flat, read_off, r_lens, win_idx, draft_off, d_lens0,
                 N, S, W, rounds, match, mismatch, gap, axis=None,
                 vote_impl="scatter", engine="wavefront"):
    """The multi-round consensus body (device side).

    ``axis``: optional mesh axis name.  When set, the READ batch is the
    per-device shard of a ``shard_map`` over that axis while ``flat`` and
    the draft metadata are replicated; the additive vote tables are
    psum-merged each round so the vote + draft compaction runs replicated
    and every device carries identical drafts into the next round — the
    multi-chip mapping of SURVEY.md §2.3 (data-parallel reads, replicated
    index, psum-merged per-window counts)."""
    reads = _unpack_rows(flat, read_off, r_lens, S)
    drafts = _unpack_rows(flat, draft_off, d_lens0, S)
    d_lens = d_lens0
    overflow = jnp.zeros((N,), jnp.int32)
    dropped = jnp.zeros((N,), jnp.int32)
    for _ in range(rounds):
        dl_r = d_lens[win_idx]
        dr_r = drafts[win_idx]
        ok = (
            (r_lens > 0)
            & (dl_r > 0)
            & (jnp.abs(r_lens - dl_r) < W // 2 - 4)
        )
        skipped = (r_lens > 0) & (dl_r > 0) & ~ok
        drop_r = jnp.zeros((N,), jnp.int32).at[
            jnp.where(skipped, win_idx, DUMP)
        ].add(1, mode="drop")
        if axis is not None:
            drop_r = jax.lax.psum(drop_r, axis)
        dropped = jnp.maximum(dropped, drop_r)
        mapping = _align_mapping_inner(
            reads, r_lens, dr_r, dl_r, S, S, W, match, mismatch, gap,
            engine,
        )
        scatter_fn = _SCATTER_IMPLS[vote_impl]
        tables = scatter_fn(mapping, reads, r_lens, win_idx, ok, N, S)
        if axis is not None:
            tables = jax.lax.psum(tables, axis)
        drafts, d_lens, total_keep = _vote_compact(
            *tables, drafts, d_lens, N, S
        )
        overflow = jnp.maximum(overflow, total_keep - S)
    # pack 4 codes/byte and fuse all outputs into ONE uint8 array so the
    # device->host hop is a single transfer
    codes = jnp.where(
        jnp.arange(S, dtype=jnp.int32)[None, :] < d_lens[:, None],
        drafts.astype(jnp.int32) & 3,
        0,
    )
    g = codes.reshape(N, S // 4, 4)
    packed = (
        g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4) | (g[..., 3] << 6)
    ).astype(jnp.uint8)
    tail = jax.lax.bitcast_convert_type(
        jnp.stack([d_lens.astype(jnp.int32), overflow, dropped]),
        jnp.uint8,
    ).reshape(-1)
    return jnp.concatenate([packed.reshape(-1), tail])


# which vote-table builder production uses: "scatter" (direct int32
# scatter-adds, atomics on the GPU), "sort" (sort+RLE+ascending scatters)
# or "packed"; all produce identical tables (tested)
VOTE_IMPL = "scatter"

# test knob: cap the per-dispatch read batch so sub-group splitting can
# be exercised at CI scale (None = the memory-derived cap of max_batch)
MAX_B_OVERRIDE: int | None = None

# batch padding multiple per device: the row-scan DP takes any batch (the
# CUDA kernel runs one block per read, the XLA scan has no grouping), so
# the unit only keeps the padded shapes few
B_UNIT = 8


def max_batch(S: int, W: int, n_dev: int = 1) -> int:
    """Reads per dispatch for bucket S, at least 64: 1 GiB per device of
    (2S+1, B, W) uint8 directions, the wavefront oracle's tensor and
    twice the XLA row scan's (S+1, B, W)."""
    max_b = max(64, n_dev * (1 << 30) // ((2 * S + 1) * W))
    if MAX_B_OVERRIDE is not None:
        max_b = min(max_b, MAX_B_OVERRIDE)
    return max_b


def _pad_batch(n_pairs: int, n_dev: int = 1) -> int:
    """Padded batch: B_UNIT * n_dev times a power of two, so every device
    of the mesh gets an equal shard."""
    return _pad_shape(n_pairs, B_UNIT * n_dev)


@functools.partial(
    jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9, 10)
)
def _dense_rounds_fused(flat, meta, N, S, W, rounds, match, mismatch, gap,
                        vote_impl, engine):
    """Whole multi-round bucket consensus as ONE compiled program: one
    dispatch per batch, not one per stage."""
    B = (meta.shape[0] - 2 * N) // 3
    read_off = meta[:B]
    r_lens = meta[B : 2 * B]
    win_idx = meta[2 * B : 3 * B]
    draft_off = meta[3 * B : 3 * B + N]
    d_lens = meta[3 * B + N :]
    return _rounds_impl(
        flat, read_off, r_lens, win_idx, draft_off, d_lens,
        N, S, W, rounds, match, mismatch, gap,
        axis=None, vote_impl=vote_impl, engine=engine,
    )


def _dense_rounds(flat, meta, N, S, W, rounds, match, mismatch, gap,
                  vote_impl="scatter"):
    """Single-device multi-round consensus for one bucket (one fused
    dispatch; the caller materializes the packed output)."""
    return _dense_rounds_fused(
        jnp.asarray(flat), jnp.asarray(meta), N, S, W, rounds, match,
        mismatch, gap, vote_impl, nw._resolve_engine(None),
    )


@functools.lru_cache(maxsize=None)
def _make_sharded_rounds(mesh, N, S, W, rounds, match, mismatch, gap,
                         vote_impl="scatter", engine="wavefront"):
    """Jitted shard_map of the round body over the mesh's ``dp`` axis:
    reads data-parallel, flat code array + draft meta replicated, vote
    tables psum-merged, output replicated (identical on every device)."""
    from jax.sharding import PartitionSpec as P

    def _step(flat, rmeta, dmeta):
        return _rounds_impl(
            flat, rmeta[0], rmeta[1], rmeta[2], dmeta[0], dmeta[1],
            N, S, W, rounds, match, mismatch, gap, axis="dp",
            vote_impl=vote_impl, engine=engine,
        )

    # check_vma=True: the NW scan anchors its carries (and the CUDA
    # kernel its row bases) to device-varying inputs, so the static
    # replication checker verifies the whole round;
    # the output is replicated because vote tables psum-merge before any
    # draft update (dryrun_multichip additionally asserts bit-equality
    # with the single-device path).
    sm = jax.shard_map(
        _step,
        mesh=mesh,
        in_specs=(P(), P(None, "dp"), P()),
        out_specs=P(),
        check_vma=True,
    )
    return jax.jit(sm)


def _unpack_host(packed_row: np.ndarray, length: int) -> np.ndarray:
    b = packed_row[: (length + 3) // 4]
    out = np.empty(((len(b)) * 4,), np.uint8)
    out[0::4] = b & 3
    out[1::4] = (b >> 2) & 3
    out[2::4] = (b >> 4) & 3
    out[3::4] = (b >> 6) & 3
    return out[:length]


# oversized-window splitting: drafts longer than the largest device
# bucket are cut into ~SEG_TARGET-bp colinear segments (each support cut
# at the homologous position, found by matching a SEG_ANCHOR_K-mer of
# the draft within +-SEG_SEARCH of the proportional position), polished
# as ordinary windows, and stitched back by concatenation — the device
# twin of the reference's handle-every-window SPOA loop
# (Assemble.cpp:499-555), which has no length cap
SEG_TARGET = 24576
SEG_ANCHOR_K = 24
SEG_SEARCH = 384


def _refined_cuts(sup: np.ndarray, draft: np.ndarray,
                  cuts_d: np.ndarray) -> list[int]:
    """Cut positions in ``sup`` homologous to draft positions ``cuts_d``.

    For each draft cut, the draft's preceding SEG_ANCHOR_K-mer is matched
    (max base agreement) inside a +-SEG_SEARCH window around the
    proportional position in ``sup``; a weak best match (< 75% identity —
    the read may not span this region) falls back to the proportional
    position.  Cuts are forced strictly monotone."""
    L, Lc = len(draft), len(sup)
    K = SEG_ANCHOR_K
    out: list[int] = []
    prev = 0
    for cd in cuts_d:
        p0 = int(round(cd * Lc / max(1, L)))
        best = min(max(p0, prev), Lc)
        if cd >= K and Lc >= K:
            pat = draft[cd - K : cd]
            lo = max(K, p0 - SEG_SEARCH)
            hi = min(Lc, p0 + SEG_SEARCH)
            if hi - lo > 0:
                wins = np.lib.stride_tricks.sliding_window_view(
                    sup[lo - K : hi], K
                )
                scores = (wins == pat[None, :]).sum(axis=1)
                j = int(np.argmax(scores))
                if scores[j] >= (3 * K) // 4:
                    best = lo + j
        best = min(max(best, prev), Lc)
        out.append(best)
        prev = best
    return [0] + out + [Lc]


def _expand_oversized(window_codes, warn):
    """Replace windows whose median draft exceeds the largest device
    bucket with colinear segment windows.

    Returns ``(work_windows, plan)`` where ``plan[wi]`` is either
    ``("one", j)`` (window wi = work window j), ``("cat", [j...])``
    (window wi = concatenation of those work windows' consensuses), or
    ``("empty",)``."""
    work: list[list[np.ndarray]] = []
    plan: list[tuple] = []
    n_split = n_seg_total = 0
    W_top = _band_width(BUCKETS[-1])
    for codes in window_codes:
        nonempty = [c for c in codes if len(c) > 0]
        if not nonempty:
            plan.append(("empty",))
            continue
        by_len = sorted(nonempty, key=len)
        draft = by_len[len(by_len) // 2]
        if len(draft) + W_top // 2 <= BUCKETS[-1]:
            plan.append(("one", len(work)))
            work.append(codes)
            continue
        # split: even draft cuts, homologous support cuts
        L = len(draft)
        n_seg = -(-L // SEG_TARGET)
        cuts_d = np.round(
            np.arange(1, n_seg) * (L / n_seg)
        ).astype(np.int64)
        seg_lists: list[list[np.ndarray]] = [[] for _ in range(n_seg)]
        for sup in nonempty:
            cp = _refined_cuts(sup, draft, cuts_d)
            for s in range(n_seg):
                seg_lists[s].append(sup[cp[s] : cp[s + 1]])
        idxs = list(range(len(work), len(work) + n_seg))
        plan.append(("cat", idxs))
        work.extend(seg_lists)
        n_split += 1
        n_seg_total += n_seg
    if n_split and warn is not None:
        warn(
            f"consensus: {n_split} window(s) beyond the {BUCKETS[-1]} bp "
            f"device bucket split into {n_seg_total} colinear segments "
            "for device polish (stitched back after consensus)"
        )
    return work, plan


def dense_consensus(
    window_codes: list[list[np.ndarray]],
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
    rounds: int = 2,
    warn=None,
    mesh=None,
) -> list[np.ndarray]:
    """Consensus codes per window, one device round trip per bucket.

    ``window_codes``: per window, the supporting subsequences as uint8
    2-bit code arrays.  ``warn``: optional callable for overflow/drop
    notices (windows whose consensus hit the bucket cap).  ``mesh``: an
    optional ``jax.sharding.Mesh`` with a ``dp`` axis; when given, each
    bucket's read batch is sharded across the mesh and vote tables merge
    with psum — output is bit-identical to the single-device path.

    Windows whose median draft exceeds the largest device bucket are
    split into colinear segments, polished as ordinary windows, and
    stitched back (see :func:`_expand_oversized`)."""
    work_windows, plan = _expand_oversized(window_codes, warn)
    work_results = _dense_consensus_work(
        work_windows, match, mismatch, gap, rounds, warn, mesh
    )
    out: list[np.ndarray] = []
    for entry in plan:
        if entry[0] == "empty":
            out.append(np.zeros(0, np.uint8))
        elif entry[0] == "one":
            out.append(work_results[entry[1]])
        else:
            out.append(np.concatenate([work_results[j] for j in entry[1]]))
    return out


def _dense_consensus_work(
    window_codes: list[list[np.ndarray]],
    match: int,
    mismatch: int,
    gap: int,
    rounds: int,
    warn,
    mesh,
) -> list[np.ndarray]:
    """The bucketed device pipeline over pre-expanded windows (every
    window here fits a device bucket)."""
    n_win = len(window_codes)
    results: list[np.ndarray | None] = [None] * n_win

    # pick drafts + assign buckets on host (cheap)
    groups: dict[int, list[int]] = {}
    drafts0: list[np.ndarray] = []
    for wi, codes in enumerate(window_codes):
        nonempty = [c for c in codes if len(c) > 0]
        if not nonempty:
            drafts0.append(np.zeros(0, np.uint8))
            results[wi] = np.zeros(0, np.uint8)
            continue
        by_len = sorted(nonempty, key=len)
        draft = by_len[len(by_len) // 2]
        drafts0.append(draft)
        S0 = _bucket_size(len(draft))
        W = _band_width(S0)
        assert len(draft) + W // 2 <= BUCKETS[-1], \
            "oversized window reached the bucket pipeline unsplit"
        S = _bucket_size(len(draft) + W // 2)
        groups.setdefault(S, []).append(wi)

    n_dev = 1 if mesh is None else int(mesh.devices.size)
    pending = []
    for S, wins in sorted(groups.items()):
        W = _band_width(S)
        max_b = max_batch(S, W, n_dev)
        sub: list[list[int]] = [[]]
        sub_pairs = [0]
        acc = 0
        for wi in wins:
            cnt = sum(
                1
                for c in window_codes[wi]
                if 0 < len(c) <= S
            )
            if acc + cnt > max_b and sub[-1]:
                sub.append([])
                sub_pairs.append(0)
                acc = 0
            sub[-1].append(wi)
            acc += cnt
            sub_pairs[-1] = acc
        # share ONE padded (N, B) shape across this bucket's sub-groups so
        # they all hit the same compiled programs (the padding waste is at
        # most one sub-group's worth)
        N_pad = _pad_shape(max(len(s) for s in sub), 8)
        B_pad = _pad_batch(max(sub_pairs), n_dev)
        # dispatch every group before materializing any result: jax
        # execution is async, so later groups' H2D transfers and compute
        # overlap earlier groups' execution
        pending.extend(
            _dispatch_group(window_codes, drafts0, win_list, S, W,
                            match, mismatch, gap, rounds, mesh,
                            N_pad=N_pad, B_pad=B_pad)
            for win_list in sub
        )
    for p in pending:
        _collect_group(p, results, warn)
    return [r if r is not None else np.zeros(0, np.uint8) for r in results]


# host-side wall-clock accounting of the last dense_consensus call,
# keyed by phase (pack / device / unpack); read by scripts and bench
# diagnostics, reset with PROF.clear()
PROF: dict[str, float] = {}


def _prof(key, dt):
    PROF[key] = PROF.get(key, 0.0) + dt


def _dispatch_group(window_codes, drafts0, win_list, S, W, match,
                    mismatch, gap, rounds, mesh=None, N_pad=None,
                    B_pad=None):
    """Pack one bucket group and dispatch its device rounds WITHOUT
    blocking; returns a pending handle for :func:`_collect_group`.

    ``N_pad``/``B_pad``: caller-shared padded shapes (all sub-groups of a
    bucket use the same compiled programs)."""
    import time as _time

    _t0 = _time.time()
    flat_parts: list[np.ndarray] = []
    flat_len = 0
    read_off: list[int] = []
    r_lens: list[int] = []
    win_idx: list[int] = []
    draft_off = np.zeros(len(win_list), np.int64)
    d_lens0 = np.zeros(len(win_list), np.int64)
    pairs = []  # (length, local window, code) for t_max-tight sorting
    n_skipped_long = 0
    for li, wi in enumerate(win_list):
        d = drafts0[wi]
        flat_parts.append(d)
        draft_off[li] = flat_len
        d_lens0[li] = len(d)
        flat_len += len(d)
        for c in window_codes[wi]:
            if 0 < len(c) <= S:
                pairs.append((len(c), li, c))
            elif len(c) > S:
                n_skipped_long += 1  # cannot band-fit any draft <= S
    # sort reads by length (neighbouring kernel blocks then finish at
    # similar times); offsets/ids assemble vectorized (this pack runs per
    # dispatch on the host, overlapped with the previous chain's device
    # work)
    if pairs:
        lens_a = np.fromiter(
            (p[0] for p in pairs), np.int64, count=len(pairs)
        )
        order = np.argsort(lens_a, kind="stable")
        r_lens_a = lens_a[order]
        win_idx_a = np.fromiter(
            (p[1] for p in pairs), np.int64, count=len(pairs)
        )[order]
        read_off_a = flat_len + np.concatenate(
            [[0], np.cumsum(r_lens_a[:-1])]
        )
        flat_len += int(r_lens_a.sum())
        flat_parts.extend(pairs[k][2] for k in order)
        read_off, r_lens, win_idx = read_off_a, r_lens_a, win_idx_a

    n_dev = 1 if mesh is None else int(mesh.devices.size)
    N = N_pad if N_pad is not None else _pad_shape(len(win_list), 8)
    B = B_pad if B_pad is not None else _pad_batch(len(pairs), n_dev)
    flat = (
        np.concatenate(flat_parts)
        if flat_parts
        else np.zeros(1, np.uint8)
    )
    if len(flat) == 0:
        flat = np.zeros(1, np.uint8)
    ro = np.zeros(B, np.int32)
    rl = np.zeros(B, np.int32)
    wx = np.full(B, N - 1, np.int32)  # pad reads point at a pad window
    ro[: len(pairs)] = read_off
    rl[: len(pairs)] = r_lens
    wx[: len(pairs)] = win_idx
    do = np.zeros(N, np.int32)
    dl = np.zeros(N, np.int32)
    do[: len(win_list)] = draft_off
    dl[: len(win_list)] = d_lens0

    from haslr_tpu.kernels.kmer_stream import pack2

    flat = pack2(flat)

    _prof("pack", _time.time() - _t0)
    _prof("n_dispatch", 1)
    _t0 = _time.time()
    if mesh is None:
        meta = np.concatenate([ro, rl, wx, do, dl]).astype(np.int32)
        out = _dense_rounds(
            jnp.asarray(flat), jnp.asarray(meta),
            N, S, W, rounds, match, mismatch, gap, VOTE_IMPL,
        )
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        rmeta = np.stack([ro, rl, wx]).astype(np.int32)
        dmeta = np.stack([do, dl]).astype(np.int32)
        fn = _make_sharded_rounds(
            mesh, N, S, W, rounds, match, mismatch, gap, VOTE_IMPL,
            nw._resolve_engine(None),
        )
        out = fn(
            jax.device_put(flat, NamedSharding(mesh, P())),
            jax.device_put(rmeta, NamedSharding(mesh, P(None, "dp"))),
            jax.device_put(dmeta, NamedSharding(mesh, P())),
        )
    _prof(f"dispatch_S{S}_B{B}", _time.time() - _t0)
    return (out, win_list, S, B, n_skipped_long)


def _collect_group(pending, results, warn):
    """Materialize one dispatched group and unpack its windows."""
    import time as _time

    out_dev, win_list, S, B, n_skipped_long = pending
    _t0 = _time.time()
    out = np.asarray(out_dev)
    _prof(f"device_S{S}_B{B}", _time.time() - _t0)
    _t0 = _time.time()
    # layout: N*(S/4) packed draft bytes + 3 int32 tail rows per window
    N = len(out) // (S // 4 + 12)
    packed = out[: N * (S // 4)].reshape(N, S // 4)
    tail = out[N * (S // 4) :].view(np.int32).reshape(3, N)
    d_lens, overflow, dropped = tail[0], tail[1], tail[2]
    n_over = int((overflow[: len(win_list)] > 0).sum())
    if n_over and warn is not None:
        warn(
            f"consensus: {n_over} window(s) hit the {S} bp bucket cap "
            f"(max overflow {int(overflow.max())} bp); consider the host "
            "POA path for these edges"
        )
    n_drop = int(dropped[: len(win_list)].sum()) + n_skipped_long
    if n_drop and warn is not None:
        warn(
            f"consensus: {n_drop} band-incompatible supporting read(s) "
            f"skipped across {len(win_list)} window(s) in the {S} bp "
            "bucket (length differs from the draft by >= W/2)"
        )
    for li, wi in enumerate(win_list):
        results[wi] = _unpack_host(packed[li], int(d_lens[li]))
    _prof("unpack", _time.time() - _t0)
