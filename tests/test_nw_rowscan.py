"""Row-scan NW engine: the XLA scan against the wavefront oracle (at
every band width), the kernel-or-XLA shape rule, the CIGAR-run contract,
and engine-flip consistency of the consensus pipeline."""

import numpy as np
import pytest

import jax.numpy as jnp

from haslr_tpu.kernels import nw
from haslr_tpu.kernels import nw_rowscan as rs


def _mutated_batch(rng, B, S, sub=0.04, ins=0.03, dele=0.03, pad_rows=4):
    """Reads mutated from their drafts; last ``pad_rows`` rows stay pure
    padding (r_len = d_len = 0)."""
    reads = np.full((B, S), 4, np.uint8)
    drafts = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.zeros(B, np.int32)
    for b in range(B - pad_rows):
        dl = int(rng.integers(50, S - 10))
        d = rng.integers(0, 4, dl).astype(np.uint8)
        r = []
        for ch in d:
            x = rng.random()
            if x < dele:
                continue
            if x < dele + ins:
                r.append(int(rng.integers(0, 4)))
            if x < dele + ins + sub:
                r.append(int(rng.integers(0, 4)))
                continue
            r.append(int(ch))
        r = np.array(r[:S], np.uint8)
        reads[b, : len(r)] = r
        drafts[b, :dl] = d
        r_lens[b] = len(r)
        d_lens[b] = dl
    return reads, r_lens, drafts, d_lens


def test_row_bases_monotone_unit_steps():
    for S in (128, 256, 512, 1024):
        b = rs.row_bases(S, S, 128)
        assert b[0] == 0
        d = np.diff(b)
        assert ((d == 0) | (d == 1)).all()
        assert b[-1] == S - 128 + 1
        assert rs.rowscan_supported(S, S, 128)


def test_rowscan_xla_matches_wavefront_oracle():
    """On moderate-drift alignments (every read the admission gate
    accepts, with real indel noise) the narrower row band contains the
    optimal path, so the row-scan mapping equals the wavefront's."""
    B, S, W = 32, 256, 128
    rng = np.random.default_rng(3)
    reads, r_lens, drafts, d_lens = _mutated_batch(rng, B, S)
    # keep every read inside the admission gate
    for b in range(B):
        if abs(int(r_lens[b]) - int(d_lens[b])) >= W // 2 - 4:
            r_lens[b] = d_lens[b]
    args = (
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts), jnp.asarray(d_lens),
    )
    wf = np.asarray(
        nw._align_mapping(*args, S, S, W, 5, -4, -8, "wavefront")
    )
    rsm = np.asarray(
        nw._align_mapping(*args, S, S, W, 5, -4, -8, "rowscan")
    )
    np.testing.assert_array_equal(wf, rsm)


def test_rowscan_alignment_semantics():
    """Canonical single-pair cases through the row-scan XLA path."""
    from haslr_tpu.core import seq as cseq

    def align(read, draft, S=128, W=128):
        reads = np.full((1, S), 4, np.uint8)
        drafts = np.full((1, S), 4, np.uint8)
        reads[0, : len(read)] = cseq.encode(read)
        drafts[0, : len(draft)] = cseq.encode(draft)
        m = np.asarray(
            nw._align_mapping(
                jnp.asarray(reads), jnp.asarray([len(read)], np.int32),
                jnp.asarray(drafts), jnp.asarray([len(draft)], np.int32),
                S, S, W, 5, -4, -8, "rowscan",
            )
        )
        return m[0, : len(read)]

    s = "ACGTACGTTGCA" * 4
    np.testing.assert_array_equal(align(s, s), np.arange(len(s)))

    draft = "ACGTACGTACGTACGT"
    read = "ACGTACGAACGTACGT"  # one substitution
    np.testing.assert_array_equal(align(read, draft), np.arange(len(read)))

    draft = "AACCGGTTAACCGGTT"
    read = "AACCGGTAACCGGTT"  # one deletion in the read
    m = align(read, draft)
    aligned = m[m >= 0]
    assert (np.diff(aligned) >= 1).all()
    assert set(np.diff(aligned)) == {1, 2}

    draft = "AACCGGTTAACCGGTT"
    read = "AACCGGTTTAACCGGTT"  # one inserted T
    m = align(read, draft)
    ins = m[m <= -2]
    assert len(ins) == 1
    anchor = -int(ins[0]) - 3
    assert 4 <= anchor <= 8  # any anchor in the homopolymer context


def test_cigar_runs_match_mapping_conversion():
    """The device CIGAR-run traceback, decoded, equals the mapping ->
    CIGAR conversion (ops, lens, n_eq) for every read — the contract the
    aligner's extension stage relies on."""
    from haslr_tpu.aligner.extend import _decode_runs_py, mapping_to_cigar
    from haslr_tpu import native as hx

    B, S, W = 64, 256, 128
    rng = np.random.default_rng(17)
    reads, r_lens, drafts, d_lens = _mutated_batch(
        rng, B, S, sub=0.05, ins=0.04, dele=0.04
    )
    args = (
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts), jnp.asarray(d_lens),
    )
    MAXR = 128
    mapping = np.asarray(
        nw._align_mapping(*args, S, S, W, 2, -4, -2, "rowscan")
    )
    runs, n_runs = rs._rowscan_cigar_inner(*args, S, S, W, 2, -4, -2, MAXR)
    runs = np.asarray(runs).astype(np.uint16)
    n_runs = np.asarray(n_runs)
    assert (n_runs[: B - 4] > 0).all()
    assert (n_runs <= MAXR).all()

    native_rows = hx.runs_cigars_native(
        runs, n_runs, reads, drafts, r_lens, d_lens
    )
    for b in range(B):
        q = reads[b, : r_lens[b]]
        t = drafts[b, : d_lens[b]]
        exp_o, exp_l, exp_ne = mapping_to_cigar(mapping[b], q, t)
        got_o, got_l, got_ne = _decode_runs_py(runs[b], int(n_runs[b]), q, t)
        np.testing.assert_array_equal(exp_o, got_o)
        np.testing.assert_array_equal(exp_l, got_l)
        assert exp_ne == got_ne
        if native_rows is not None:
            no, nl, nne = native_rows[b]
            np.testing.assert_array_equal(exp_o, no)
            np.testing.assert_array_equal(exp_l, nl.astype(exp_l.dtype))
            assert exp_ne == nne


def test_cigar_runs_overflow_flagged():
    """Reads with more runs than MAXR must report their true count (the
    caller falls back to a host alignment, never a truncated CIGAR)."""
    B, S, W = 32, 256, 128
    rng = np.random.default_rng(23)
    # indel-dense reads: an insertion after every other base => ~1.5
    # runs per draft base, far past a small MAXR
    drafts = np.full((B, S), 4, np.uint8)
    reads = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.zeros(B, np.int32)
    for b in range(B):
        dl = 150
        d = rng.integers(0, 4, dl).astype(np.uint8)
        r = []
        for p, ch in enumerate(d):
            r.append(int(ch))
            if p % 2 == 0 and p < 80:
                r.append(int(rng.integers(0, 4)))
        r = np.array(r, np.uint8)
        reads[b, : len(r)] = r
        drafts[b, :dl] = d
        r_lens[b] = len(r)
        d_lens[b] = dl
    MAXR = 64  # < the ~80 runs these reads need
    runs, n_runs = rs._rowscan_cigar_inner(
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts), jnp.asarray(d_lens),
        S, S, W, 2, -4, -2, MAXR,
    )
    n_runs = np.asarray(n_runs)
    from haslr_tpu.aligner.extend import _decode_runs_py

    runs = np.asarray(runs).astype(np.uint16)
    for b in range(B):
        if n_runs[b] > MAXR:
            _, _, ne = _decode_runs_py(
                runs[b], int(n_runs[b]),
                reads[b, : r_lens[b]], drafts[b, : d_lens[b]],
            )
            assert ne == -1
    assert (n_runs > MAXR).any()


def test_batch_align_segments_runs_path():
    """End-to-end: the aligner's batched extension through the CIGAR-run
    device path consumes both sequences exactly and matches the host
    banded NW on clean segments."""
    from haslr_tpu.aligner.extend import batch_align_segments, nw_cigar
    from haslr_tpu.core import cigar as ccigar

    rng = np.random.default_rng(31)
    segments = []
    for _ in range(40):
        L = int(rng.integers(20, 400))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = []
        for ch in t:
            x = rng.random()
            if x < 0.03:
                continue
            if x < 0.06:
                q.append(int(rng.integers(0, 4)))
            q.append(int(ch))
        segments.append((np.array(q, np.uint8), t))
    out = batch_align_segments(segments)
    for (q, t), (o, l, ne) in zip(segments, out):
        qc = int(np.sum(np.where(o != ccigar.D, l, 0)))
        tc = int(np.sum(np.where(o != ccigar.I, l, 0)))
        assert qc == len(q) and tc == len(t)
        assert 0 <= ne <= min(len(q), len(t))


@pytest.mark.parametrize("S,W", [(512, 256), (1024, 512)])
def test_rowscan_wide_band_matches_wavefront_oracle(S, W):
    """The W = 256/512 buckets (consensus S >= 2048, extension) run the
    XLA row scan on every platform: its mapping equals the wavefront
    oracle's on admitted reads, and its CIGAR runs equal the oracle
    mapping's CIGAR."""
    from haslr_tpu.aligner.extend import _decode_runs_py, mapping_to_cigar

    B = 12
    rng = np.random.default_rng(W)
    reads, r_lens, drafts, d_lens = _mutated_batch(rng, B, S, pad_rows=2)
    for b in range(B):
        if abs(int(r_lens[b]) - int(d_lens[b])) >= W // 2 - 4:
            r_lens[b] = d_lens[b]
    args = (
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts), jnp.asarray(d_lens),
    )
    wf = np.asarray(
        nw._align_mapping(*args, S, S, W, 5, -4, -8, "wavefront")
    )
    got = np.asarray(rs.rowscan_mapping(*args, S, S, W, 5, -4, -8))
    np.testing.assert_array_equal(wf, got)

    wf2 = np.asarray(
        nw._align_mapping(*args, S, S, W, 2, -4, -2, "wavefront")
    )
    MAXR = rs.default_maxr(S)
    runs, n_runs = rs.rowscan_cigar(*args, S, S, W, 2, -4, -2, MAXR)
    runs = np.asarray(runs).astype(np.uint16)
    n_runs = np.asarray(n_runs)
    for b in range(B):
        q = reads[b, : r_lens[b]]
        t = drafts[b, : d_lens[b]]
        exp = mapping_to_cigar(wf2[b], q, t)
        got_b = _decode_runs_py(runs[b], int(n_runs[b]), q, t)
        np.testing.assert_array_equal(exp[0], got_b[0])
        np.testing.assert_array_equal(exp[1], got_b[1])
        assert exp[2] == got_b[2]


def test_kernel_shape_rule():
    """The CUDA kernel takes exactly the W = 128 buckets up to S = 1024
    with D <= R; everything wider stays on the XLA scan."""
    from haslr_tpu.kernels import consensus_dense as cd

    for S in (128, 256, 512, 1024):
        assert rs.kernel_applies(S, S, cd._band_width(S))
    for S in (2048, 4096, 16384):
        assert not rs.kernel_applies(S, S, cd._band_width(S))
    assert not rs.kernel_applies(256, 512, 128)  # D > R
    assert not rs.kernel_applies(2048, 2048, 128)  # beyond shared memory
    assert rs.kernel_applies(300, 200, 128)


def test_kernel_not_chosen_on_cpu():
    """On the CPU backend every shape runs the XLA scan (the kernel is
    built for the GPU only) — the production entry equals the XLA
    reference bit for bit."""
    assert not rs.use_kernel(512, 512, 128)
    B, S, W = 8, 256, 128
    rng = np.random.default_rng(5)
    reads, r_lens, drafts, d_lens = _mutated_batch(rng, B, S, pad_rows=1)
    args = (
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts), jnp.asarray(d_lens),
    )
    np.testing.assert_array_equal(
        np.asarray(rs.rowscan_mapping(*args, S, S, W, 5, -4, -8)),
        np.asarray(rs._rowscan_mapping_inner(*args, S, S, W, 5, -4, -8)),
    )


def test_align_mapping_unsupported_rowscan_shape_uses_wavefront():
    """D > R with a band that would jump > 1 column per row is outside
    the row scan's contract: the mapping entry falls to the wavefront."""
    R, D, W = 128, 384, 128
    assert not rs.rowscan_supported(R, D, W)
    rng = np.random.default_rng(9)
    reads = np.full((4, R), 4, np.uint8)
    drafts = np.full((4, D), 4, np.uint8)
    r_lens = np.array([100, 80, 0, 120], np.int32)
    d_lens = np.array([110, 90, 30, 125], np.int32)
    for b in range(4):
        d = rng.integers(0, 4, d_lens[b]).astype(np.uint8)
        drafts[b, : d_lens[b]] = d
        reads[b, : r_lens[b]] = d[: r_lens[b]]
    args = (
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts), jnp.asarray(d_lens),
    )
    got = np.asarray(
        nw._align_mapping(*args, R, D, W, 5, -4, -8, "rowscan")
    )
    want = np.asarray(
        nw._align_mapping(*args, R, D, W, 5, -4, -8, "wavefront")
    )
    np.testing.assert_array_equal(got, want)


def test_consensus_engines_agree():
    """The full dense consensus voted through the row-scan engine equals
    the wavefront engine's output on realistic windows (the band
    difference only matters on extreme-drift alignments the admission
    gate rejects)."""
    from haslr_tpu.kernels.consensus import batched_consensus

    rng = np.random.default_rng(23)
    bases = "ACGT"

    def mutate(s, rate=0.07):
        out = []
        for ch in s:
            r = rng.random()
            if r < rate / 3:
                continue
            if r < 2 * rate / 3:
                out.append(bases[rng.integers(0, 4)])
            else:
                out.append(ch)
                if r < rate:
                    out.append(bases[rng.integers(0, 4)])
        return "".join(out)

    windows = []
    for L in (60, 200, 500, 900):
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(9)])
    windows.append([])
    windows.append(["ACGT"])

    old = nw.ENGINE
    try:
        nw.ENGINE = "rowscan"
        out_rs = batched_consensus(windows)
        nw.ENGINE = "wavefront"
        out_wf = batched_consensus(windows)
    finally:
        nw.ENGINE = old
    assert out_rs == out_wf
