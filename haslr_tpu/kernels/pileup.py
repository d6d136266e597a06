"""Device-resident pileup accumulation and voting for window consensus.

The device twin of :class:`haslr_tpu.kernels.consensus._Pileup`: per-chunk
scatter of base/coverage/insertion votes into flat per-window tables and
the majority vote both run under jit, so the alignment mapping never
leaves the device — only the compact vote calls (a few bytes per draft
position) transfer at the end of a polish round.

Table totals are padded to power-of-two buckets so jit shapes stay stable
across assemblies (each new shape is a compile); all scatters use
``mode="drop"`` with a far out-of-bounds dump index for masked lanes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from haslr_tpu.kernels.nw import _align_mapping_inner

DUMP = np.int32(1 << 30)


def _pad_pow2(n: int, floor: int = 1024) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _scatter_chunk_inner(counts, cov_diff, ins1, ins2, n_reads, mapping,
                         reads, r_lens, woff, woff1, win_idx):
    """Accumulate one (B, S) chunk into the flat vote tables."""
    B, S = mapping.shape
    col = jnp.arange(S)[None, :]
    in_len = col < r_lens[:, None]
    m = mapping.astype(jnp.int32)
    aligned = (m >= 0) & in_len
    rbase = reads.astype(jnp.int32) & 3
    tgt = jnp.where(aligned, woff[:, None] + m, DUMP)
    counts = counts.at[tgt.reshape(-1), rbase.reshape(-1)].add(
        1, mode="drop"
    )

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

    ins = (m <= -2) & in_len
    anchors = -m - 3
    prev_ins = jnp.concatenate(
        [jnp.zeros((B, 1), bool), ins[:, :-1]], axis=1
    )
    prev_anchor = jnp.concatenate(
        [jnp.full((B, 1), -9, jnp.int32), anchors[:, :-1]], axis=1
    )
    start = ins & (~prev_ins | (anchors != prev_anchor))
    idx = jnp.broadcast_to(col, (B, S))
    last_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(start, idx, -1), axis=1
    )
    rank = idx - last_start
    row_ok = any_aligned[:, None]
    sel1 = ins & (rank == 0) & row_ok
    sel2 = ins & (rank == 1) & row_ok
    t1 = jnp.where(sel1, woff1[:, None] + anchors + 1, DUMP)
    t2 = jnp.where(sel2, woff1[:, None] + anchors + 1, DUMP)
    ins1 = ins1.at[t1.reshape(-1), rbase.reshape(-1)].add(1, mode="drop")
    ins2 = ins2.at[t2.reshape(-1), rbase.reshape(-1)].add(1, mode="drop")
    return counts, cov_diff, ins1, ins2, n_reads


_scatter_chunk = jax.jit(_scatter_chunk_inner)


@functools.partial(
    jax.jit,
    static_argnums=(12, 13, 14, 15, 16),
    donate_argnums=(0, 1, 2, 3, 4),
)
def _align_scatter(counts, cov_diff, ins1, ins2, n_reads, reads, r_lens,
                   drafts, d_lens, woff, woff1, win_idx, W, match, mismatch,
                   gap, engine):
    """Fused banded-NW align + pileup scatter: ONE device dispatch per
    chunk (the mapping tensor lives only inside this computation), with
    the vote tables donated so accumulation is in-place."""
    R = reads.shape[1]
    D = drafts.shape[1]
    mapping = _align_mapping_inner(reads, r_lens, drafts, d_lens, R, D, W,
                                   match, mismatch, gap, engine)
    return _scatter_chunk_inner(counts, cov_diff, ins1, ins2, n_reads,
                                mapping, reads, r_lens, woff, woff1,
                                win_idx)


@jax.jit
def _vote_packed(counts, cov_diff, ins1, ins2, draft_flat, d_lens_pad):
    """Majority vote with device-computed coverage indices; returns ONE
    packed uint8 array (call in bits 0-1, emit flag in bit 2) laid out as
    ``[base rows | ins1 rows | ins2 rows]`` — one bulk transfer per polish
    round.  ``d_lens_pad`` is the per-window draft length, zero-padded to
    the (static) window-table size; zero-length pad windows drop out of
    ``searchsorted(side="right")`` naturally.

    Index identities (off1[w] = off[w] + w for the +1-per-window layout):
    base row r of window w sits at coverage index ``r + w``; insertion row
    r1 covers ``r1 - (pos1 > 0)``.
    """
    n_win = d_lens_pad.shape[0]
    total = counts.shape[0]
    total1 = cov_diff.shape[0]
    off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(d_lens_pad).astype(jnp.int32)]
    )
    rows = jnp.arange(total, dtype=jnp.int32)
    win = jnp.clip(
        jnp.searchsorted(off, rows, side="right").astype(jnp.int32) - 1,
        0, n_win - 1,
    )
    base_cov_idx = jnp.clip(rows + win, 0, total1 - 1)

    off1 = off + jnp.arange(n_win + 1, dtype=jnp.int32)
    rows1 = jnp.arange(total1, dtype=jnp.int32)
    win1 = jnp.clip(
        jnp.searchsorted(off1, rows1, side="right").astype(jnp.int32) - 1,
        0, n_win - 1,
    )
    pos1 = rows1 - off1[win1]
    ins_cov_idx = jnp.clip(rows1 - (pos1 > 0), 0, total1 - 1)

    coverage = jnp.cumsum(cov_diff)
    base_sum = counts.sum(axis=1)
    base_best = counts.argmax(axis=1)
    base_best_cnt = counts[rows, base_best]
    draft_cnt = counts[rows, draft_flat.astype(jnp.int32)]
    base_call = jnp.where(
        draft_cnt == base_best_cnt, draft_flat.astype(jnp.int32), base_best
    )
    emit_base = base_best_cnt > (coverage[base_cov_idx] - base_sum)

    ins1_sum = ins1.sum(axis=1)
    ins2_sum = ins2.sum(axis=1)
    cov_prev = coverage[ins_cov_idx]
    emit_i1 = ins1_sum * 2 > jnp.maximum(cov_prev, 1)
    emit_i2 = (ins2_sum * 2 > jnp.maximum(cov_prev, 1)) & emit_i1
    packed = jnp.concatenate([
        (base_call | (emit_base.astype(jnp.int32) << 2)).astype(jnp.uint8),
        (ins1.argmax(axis=1) | (emit_i1.astype(jnp.int32) << 2)).astype(
            jnp.uint8
        ),
        (ins2.argmax(axis=1) | (emit_i2.astype(jnp.int32) << 2)).astype(
            jnp.uint8
        ),
    ])
    return packed


class DevicePileup:
    """Same contract as the host ``_Pileup`` but device-resident: the
    mapping tensors stay jnp arrays end to end."""

    def __init__(self, drafts):
        self.d_lens = np.array([len(d) for d in drafts], dtype=np.int64)
        self.off = np.concatenate([[0], np.cumsum(self.d_lens)])
        self.off1 = np.concatenate([[0], np.cumsum(self.d_lens + 1)])
        self._total = _pad_pow2(max(1, int(self.off[-1])))
        self._total1 = _pad_pow2(max(1, int(self.off1[-1])))
        nw_pad = _pad_pow2(max(1, len(drafts)), 64)
        self.counts = jnp.zeros((self._total, 4), jnp.int32)
        self.cov_diff = jnp.zeros(self._total1, jnp.int32)
        self.ins1 = jnp.zeros((self._total1, 4), jnp.int32)
        self.ins2 = jnp.zeros((self._total1, 4), jnp.int32)
        self.n_reads_dev = jnp.zeros(nw_pad, jnp.int32)

    def add_chunk_device(self, mapping_dev, reads, r_lens, win_idx):
        (self.counts, self.cov_diff, self.ins1, self.ins2,
         self.n_reads_dev) = _scatter_chunk(
            self.counts, self.cov_diff, self.ins1, self.ins2,
            self.n_reads_dev, mapping_dev, jnp.asarray(reads),
            jnp.asarray(r_lens, jnp.int32),
            jnp.asarray(self.off[win_idx], jnp.int32),
            jnp.asarray(self.off1[win_idx], jnp.int32),
            jnp.asarray(win_idx, jnp.int32),
        )

    def align_add_chunk(self, reads, r_lens, drafts, d_lens, win_idx, W,
                        match, mismatch, gap):
        """Fused path: banded-NW align + scatter in one device dispatch."""
        from haslr_tpu.kernels import nw as _nw

        (self.counts, self.cov_diff, self.ins1, self.ins2,
         self.n_reads_dev) = _align_scatter(
            self.counts, self.cov_diff, self.ins1, self.ins2,
            self.n_reads_dev, jnp.asarray(reads),
            jnp.asarray(r_lens, jnp.int32), jnp.asarray(drafts),
            jnp.asarray(d_lens, jnp.int32),
            jnp.asarray(self.off[win_idx], jnp.int32),
            jnp.asarray(self.off1[win_idx], jnp.int32),
            jnp.asarray(win_idx, jnp.int32),
            W, match, mismatch, gap, _nw._resolve_engine(None),
        )

    def vote(self, drafts):
        """Packed single-transfer vote (see :func:`_vote_packed`)."""
        n_win = len(drafts)
        draft_flat = np.zeros(self._total, np.uint8)
        if n_win and self.off[-1]:
            cat = np.concatenate(drafts)
            draft_flat[: len(cat)] = cat
        d_lens_pad = np.zeros(len(self.n_reads_dev), np.int32)
        d_lens_pad[:n_win] = self.d_lens
        packed = np.asarray(
            _vote_packed(
                self.counts, self.cov_diff, self.ins1, self.ins2,
                jnp.asarray(draft_flat), jnp.asarray(d_lens_pad),
            )
        )
        base = packed[: self._total]
        i1 = packed[self._total : self._total + self._total1]
        i2 = packed[self._total + self._total1 :]
        base_call, emit_base = base & 3, (base & 4) != 0
        ins1_call, emit_i1 = i1 & 3, (i1 & 4) != 0
        ins2_call, emit_i2 = i2 & 3, (i2 & 4) != 0
        n_reads = np.asarray(self.n_reads_dev)[:n_win] if n_win else []
        results = []
        for w, d in enumerate(drafts):
            if n_reads[w] == 0:
                results.append(d)
                continue
            Dw = len(d)
            b0, b1 = self.off[w], self.off[w + 1]
            i0, i1_ = self.off1[w], self.off1[w + 1]
            vals = np.empty(2 + 3 * Dw, dtype=np.uint8)
            keep = np.zeros(2 + 3 * Dw, dtype=bool)
            vals[0] = ins1_call[i0]
            keep[0] = emit_i1[i0]
            vals[1] = ins2_call[i0]
            keep[1] = emit_i2[i0]
            vals[2::3] = base_call[b0:b1]
            keep[2::3] = emit_base[b0:b1]
            vals[3::3] = ins1_call[i0 + 1 : i1_]
            keep[3::3] = emit_i1[i0 + 1 : i1_]
            vals[4::3] = ins2_call[i0 + 1 : i1_]
            keep[4::3] = emit_i2[i0 + 1 : i1_]
            results.append(vals[keep])
        return results
