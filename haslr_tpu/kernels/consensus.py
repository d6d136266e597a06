"""Batched window consensus: align-to-draft + weighted pileup vote.

The device-batched replacement for per-window SPOA (reference
``Assemble.cpp:479-560``).  For each backbone edge's window:

1. pick a draft = the median-length supporting subsequence;
2. length-bucket all (read, draft) pairs across *all* windows and run the
   batched banded-NW kernel (:mod:`haslr_tpu.kernels.nw`) per bucket — the
   device sees a few large ``(B, W)`` lockstep DPs instead of thousands of
   tiny irregular ones;
3. lockstep traceback + insertion-aware pileup vote (numpy, vectorized over
   the batch) → polished consensus;
4. repeat with the polished sequence as the new draft (``rounds`` times).

Majority voting across ~``edge_supp`` reads yields window accuracy
comparable to POA; ties keep the draft base.  Reads whose length differs
from the draft's by more than ~W/2 cannot be banded and are skipped (they
are chimeric/clipped outliers in practice).
"""

from __future__ import annotations

import numpy as np

from haslr_tpu.core import seq as cseq
from haslr_tpu.kernels import nw

BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


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


class _Pileup:
    """Batched pileup accumulator over all windows at once.

    Per-window count tables live concatenated in flat arrays indexed by
    per-window draft offsets, so every scatter is one ``np.add.at`` over a
    whole (B, S) chunk — no per-window or per-read Python loops.
    """

    def __init__(self, drafts: list[np.ndarray]):
        self.d_lens = np.array([len(d) for d in drafts], dtype=np.int64)
        # offsets into the base-count table (D per window) and the
        # insertion/coverage tables (D+1 per window)
        self.off = np.concatenate([[0], np.cumsum(self.d_lens)])
        self.off1 = np.concatenate([[0], np.cumsum(self.d_lens + 1)])
        total = int(self.off[-1])
        total1 = int(self.off1[-1])
        self.counts = np.zeros((total, 4), dtype=np.int32)
        self.cov_diff = np.zeros(total1 + 1, dtype=np.int32)
        self.ins1 = np.zeros((total1, 4), dtype=np.int32)
        self.ins2 = np.zeros((total1, 4), dtype=np.int32)
        self.n_reads = np.zeros(len(drafts), dtype=np.int64)

    def add_chunk(self, mapping: np.ndarray, reads: np.ndarray,
                  r_lens: np.ndarray, win_idx: np.ndarray):
        """mapping/reads: (B, S) arrays; win_idx: window id per row."""
        B, S = mapping.shape
        col = np.arange(S)[None, :]
        in_len = col < r_lens[:, None]
        aligned = (mapping >= 0) & in_len
        m64 = mapping.astype(np.int64)
        woff = self.off[win_idx][:, None]
        woff1 = self.off1[win_idx][:, None]
        # base votes
        np.add.at(
            self.counts,
            ((woff + m64)[aligned], reads[aligned].astype(np.int64)),
            1,
        )
        # coverage spans (rows with no aligned base contribute nothing)
        any_aligned = aligned.any(axis=1)
        big = np.where(aligned, m64, np.int64(1 << 40))
        small = np.where(aligned, m64, np.int64(-1))
        jmin = big.min(axis=1)[any_aligned]
        jmax = small.max(axis=1)[any_aligned]
        w1 = self.off1[win_idx[any_aligned]]
        np.add.at(self.cov_diff, w1 + jmin, 1)
        np.add.at(self.cov_diff, w1 + jmax + 1, -1)
        np.add.at(self.n_reads, win_idx[any_aligned], 1)
        # insertions: anchor a = -m - 3, ranked within runs (per row)
        ins = (mapping <= -2) & in_len
        anchors = (-m64 - 3)
        prev_ins = np.concatenate(
            [np.zeros((B, 1), bool), ins[:, :-1]], axis=1
        )
        prev_anchor = np.concatenate(
            [np.full((B, 1), -9, np.int64), anchors[:, :-1]], axis=1
        )
        start = ins & (~prev_ins | (anchors != prev_anchor))
        idx = np.broadcast_to(col, (B, S))
        last_start = np.maximum.accumulate(np.where(start, idx, -1), axis=1)
        rank = idx - last_start
        row_ok = any_aligned[:, None]
        sel1 = ins & (rank == 0) & row_ok
        sel2 = ins & (rank == 1) & row_ok
        np.add.at(
            self.ins1,
            ((woff1 + anchors + 1)[sel1], reads[sel1].astype(np.int64)),
            1,
        )
        np.add.at(
            self.ins2,
            ((woff1 + anchors + 1)[sel2], reads[sel2].astype(np.int64)),
            1,
        )

    def vote(self, drafts: list[np.ndarray]) -> list[np.ndarray]:
        """Emit the voted consensus per window (vectorized)."""
        draft_flat = (
            np.concatenate(drafts) if drafts else np.zeros(0, np.uint8)
        )
        total = len(draft_flat)
        coverage = np.cumsum(self.cov_diff[:-1])  # over off1 layout
        base_sum = self.counts.sum(axis=1)
        base_best = self.counts.argmax(axis=1)
        rows = np.arange(total)
        base_best_cnt = self.counts[rows, base_best]
        draft_cnt = self.counts[rows, draft_flat]
        base_call = np.where(
            draft_cnt == base_best_cnt, draft_flat, base_best
        ).astype(np.uint8)
        # per-position coverage: position p of window w is coverage at
        # off1[w] + p (cumsum over the diff array within the window)
        pos_in_win = rows - np.repeat(self.off[:-1], np.diff(self.off))
        win_of_row = np.repeat(
            np.arange(len(self.d_lens)), np.diff(self.off)
        )
        cov_at_base = coverage[self.off1[win_of_row] + pos_in_win]
        emit_base = base_best_cnt > (cov_at_base - base_sum)

        ins1_sum = self.ins1.sum(axis=1)
        ins2_sum = self.ins2.sum(axis=1)
        # coverage "before" slot a+1 mirrors the original per-window rule
        rows1 = np.arange(len(ins1_sum))
        pos1 = rows1 - np.repeat(self.off1[:-1], np.diff(self.off1))
        win1 = np.repeat(np.arange(len(self.d_lens)), np.diff(self.off1))
        cov_prev = coverage[self.off1[win1] + np.maximum(pos1 - 1, 0)]
        emit_ins1 = ins1_sum * 2 > np.maximum(cov_prev, 1)
        emit_ins2 = (ins2_sum * 2 > np.maximum(cov_prev, 1)) & emit_ins1
        ins1_best = self.ins1.argmax(axis=1).astype(np.uint8)
        ins2_best = self.ins2.argmax(axis=1).astype(np.uint8)

        out = []
        for w, d in enumerate(drafts):
            if self.n_reads[w] == 0:
                out.append(d)
                continue
            Dw = len(d)
            b0, b1 = self.off[w], self.off[w + 1]
            i0, i1 = self.off1[w], self.off1[w + 1]
            # slot order per window: ins1[0], ins2[0], then for each p:
            # base[p], ins1[p+1], ins2[p+1]
            vals = np.empty(2 + 3 * Dw, dtype=np.uint8)
            keep = np.zeros(2 + 3 * Dw, dtype=bool)
            vals[0] = ins1_best[i0]
            keep[0] = emit_ins1[i0]
            vals[1] = ins2_best[i0]
            keep[1] = emit_ins2[i0]
            vals[2::3] = base_call[b0:b1]
            keep[2::3] = emit_base[b0:b1]
            vals[3::3] = ins1_best[i0 + 1 : i1]
            keep[3::3] = emit_ins1[i0 + 1 : i1]
            vals[4::3] = ins2_best[i0 + 1 : i1]
            keep[4::3] = emit_ins2[i0 + 1 : i1]
            out.append(vals[keep])
        return out


def _one_round(window_codes, drafts, match, mismatch, gap,
               device_pileup=True):
    """One align+vote polish round for all windows; returns new drafts.

    ``device_pileup`` keeps the vote tables and mapping on device (the
    host accumulator remains as the reference implementation)."""
    # bucket (win, read) pairs
    jobs = {}  # (S) -> list of (win_idx, read_idx)
    for wi, (codes_list, draft) in enumerate(zip(window_codes, drafts)):
        if len(codes_list) <= 1 or len(draft) == 0:
            continue
        # bucket on the draft length alone: band-incompatible outlier reads
        # (e.g. whole-suffix artifacts) are dropped, not allowed to inflate
        # the padded problem size for the whole window
        S0 = _bucket_size(len(draft))
        W = _band_width(S0)
        S = _bucket_size(len(draft) + W // 2)
        W = _band_width(S)
        for ri, c in enumerate(codes_list):
            if abs(len(c) - len(draft)) >= W // 2 - 4:
                continue  # cannot band; outlier
            if len(c) == 0 or len(c) > S:
                continue
            jobs.setdefault(S, []).append((wi, ri))
    if device_pileup:
        from haslr_tpu.kernels.pileup import DevicePileup

        pile = DevicePileup(drafts)
    else:
        pile = _Pileup(drafts)
    for S, pairs in sorted(jobs.items()):
        W = _band_width(S)
        # cap batch so the on-device direction tensor stays modest
        max_b = max(1, (512 << 20) // ((2 * S + 1) * W))
        for lo in range(0, len(pairs), max_b):
            chunk = pairs[lo : lo + max_b]
            # pad the batch to a power of two (>= 32) so jit shapes stay
            # stable
            B = 32
            while B < len(chunk):
                B *= 2
            reads = np.full((B, S), 4, dtype=np.uint8)
            dr = np.full((B, S), 4, dtype=np.uint8)
            r_lens = np.zeros(B, dtype=np.int32)
            d_lens = np.zeros(B, dtype=np.int32)
            win_idx = np.zeros(B, dtype=np.int64)
            for k, (wi, ri) in enumerate(chunk):
                c = window_codes[wi][ri]
                d = drafts[wi]
                reads[k, : len(c)] = c
                dr[k, : len(d)] = d
                r_lens[k] = len(c)
                d_lens[k] = len(d)
                win_idx[k] = wi
            if device_pileup:
                # fully device-resident, single dispatch: align + scatter
                # fused so the mapping never leaves the device
                pile.align_add_chunk(
                    reads, r_lens, dr, d_lens, win_idx, W, match, mismatch,
                    gap,
                )
            else:
                mapping = nw.align_mapping_device(
                    reads, r_lens, dr, d_lens, W, match, mismatch, gap
                )
                pile.add_chunk(mapping, reads, r_lens, win_idx)
    return pile.vote(drafts)


def batched_consensus(
    windows: list[list[str]],
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
    rounds: int = 2,
    device_pileup: bool = True,
    engine: str = "dense",
    warn=None,
    mesh=None,
) -> list[str]:
    """Consensus string per window (list of supporting subsequences).

    ``engine="dense"`` (default) runs the whole multi-round consensus in
    one device computation per length bucket
    (:mod:`haslr_tpu.kernels.consensus_dense`); ``engine="chunked"`` is
    the round-1 path that hops back to host between rounds (kept as a
    reference implementation — both must produce identical output).
    ``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis — the
    dense engine shards each bucket's read batch across it (bit-identical
    output)."""
    window_codes = []
    for seqs in windows:
        window_codes.append([cseq.encode(s) for s in seqs if len(s) > 0])
    if engine == "dense":
        from haslr_tpu.kernels.consensus_dense import dense_consensus

        drafts = dense_consensus(window_codes, match, mismatch, gap,
                                 rounds, warn=warn, mesh=mesh)
        return [cseq.decode(d) for d in drafts]
    drafts = []
    for codes in window_codes:
        if not codes:
            drafts.append(np.zeros(0, dtype=np.uint8))
        else:
            by_len = sorted(codes, key=len)
            drafts.append(by_len[len(by_len) // 2])
    for _ in range(rounds):
        drafts = _one_round(window_codes, drafts, match, mismatch, gap,
                            device_pileup=device_pileup)
    return [cseq.decode(d) for d in drafts]
