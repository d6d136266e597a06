"""Tests for the batched NW kernel and the device consensus engine
(running on CPU via the pure-JAX path)."""

import numpy as np
import pytest

from haslr_tpu.core import seq as cseq
from haslr_tpu.kernels import nw
from haslr_tpu.kernels.consensus import batched_consensus


def _align_pair(read: str, draft: str, W=128):
    r = cseq.encode(read)[None, :]
    d = cseq.encode(draft)[None, :]
    R = ((len(read) + 127) // 128) * 128
    D = ((len(draft) + 127) // 128) * 128
    S = max(R, D, 128)
    reads = np.full((1, S), 4, dtype=np.uint8)
    drafts = np.full((1, S), 4, dtype=np.uint8)
    reads[0, : r.shape[1]] = r
    drafts[0, : d.shape[1]] = d
    dirs, base = nw.banded_nw_batch(
        reads, np.array([len(read)]), drafts, np.array([len(draft)]), W
    )
    m = nw.traceback_batch(
        dirs, base, np.array([len(read)]), np.array([len(draft)]), S
    )
    return m[0, : len(read)]


def test_nw_identity():
    s = "ACGTACGTTGCA" * 4
    m = _align_pair(s, s)
    np.testing.assert_array_equal(m, np.arange(len(s)))


def test_nw_substitution():
    draft = "ACGTACGTACGTACGT"
    read = "ACGTACGAACGTACGT"  # one substitution, same length
    m = _align_pair(read, draft)
    np.testing.assert_array_equal(m, np.arange(len(read)))


def test_nw_deletion_in_read():
    draft = "AACCGGTTAACCGGTT"
    read = "AACCGGTAACCGGTT"  # draft pos 7 deleted
    m = _align_pair(read, draft)
    assert len(m) == 15
    # mapping must be strictly increasing over aligned positions, draft pos
    # 7 or equivalent skipped
    aligned = m[m >= 0]
    assert (np.diff(aligned) >= 1).all()
    assert set(np.diff(aligned)) == {1, 2}


def test_nw_insertion_in_read():
    draft = "AACCGGTTAACCGGTT"
    read = "AACCGGTTXAACCGGTT".replace("X", "T")
    m = _align_pair(read, draft)
    ins = m[m <= -2]
    assert len(ins) == 1
    anchor = -int(ins[0]) - 3
    # any anchor inside the G/T homopolymer context is score-equivalent
    assert 4 <= anchor <= 8


def test_device_mapping_matches_host_traceback():
    """align_mapping_device must reproduce the host dirs+traceback path."""
    rng = np.random.default_rng(13)
    B, S, W = 8, 256, 128
    reads = rng.integers(0, 4, (B, S)).astype(np.uint8)
    drafts = reads.copy()
    # perturb reads with indels/substitutions
    for b in range(B):
        for _ in range(10):
            p = int(rng.integers(0, S - 1))
            reads[b, p] = rng.integers(0, 4)
    r_lens = rng.integers(150, 250, B).astype(np.int32)
    d_lens = (r_lens + rng.integers(-5, 6, B)).astype(np.int32)
    dirs, base = nw.banded_nw_batch(reads, r_lens, drafts, d_lens, W)
    m_host = nw.traceback_batch(dirs, base, r_lens, d_lens, S)
    m_dev = nw.align_mapping_device(reads, r_lens, drafts, d_lens, W)
    np.testing.assert_array_equal(m_host, m_dev)


def test_batched_consensus_identical():
    s = "ACGTTGCAGGACCATAGGACCA"
    out = batched_consensus([[s, s, s]])
    assert out == [s]


def test_batched_consensus_empty_and_single():
    assert batched_consensus([[]]) == [""]
    assert batched_consensus([["ACGT"]]) == ["ACGT"]
    assert batched_consensus([["", ""]]) == [""]


def test_batched_consensus_majority():
    rng = np.random.default_rng(5)
    bases = "ACGT"
    true = "".join(bases[i] for i in rng.integers(0, 4, 400))

    def mutate(s, rate=0.08):
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

    windows = [[mutate(true) for _ in range(13)] for _ in range(3)]
    outs = batched_consensus(windows)
    for cons in outs:
        assert abs(len(cons) - len(true)) < 12
        # identity via shared kmers
        k = 21
        tk = {true[i : i + k] for i in range(len(true) - k + 1)}
        ck = {cons[i : i + k] for i in range(len(cons) - k + 1)}
        shared = len(tk & ck) / len(tk)
        assert shared > 0.9, shared


def test_device_pileup_matches_host_pileup():
    """Both pileup engines must vote the exact same consensus."""
    rng = np.random.default_rng(21)
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
    for L in (80, 250, 600):
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(9)])
    dev = batched_consensus(windows, device_pileup=True, engine="chunked")
    host = batched_consensus(
        windows, device_pileup=False, engine="chunked"
    )
    assert dev == host


def test_dense_engine_matches_chunked():
    """The device-resident multi-round engine must vote the exact same
    consensus as the round-1 host-hop engine on every window shape."""
    rng = np.random.default_rng(33)
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
    for L in (60, 200, 500):
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(9)])
    windows.append([])
    windows.append(["ACGT"])
    windows.append(["", ""])
    s = "ACGTTGCAGGACCATAGGACCA"
    windows.append([s, s, s])
    dense = batched_consensus(windows, engine="dense")
    chunk = batched_consensus(windows, engine="chunked")
    assert dense == chunk


def test_long_window_40kb():
    """Windows far past the old 16 kb cap must produce a real consensus
    through the big-bucket scan path (reference SPOA handles any span,
    Assemble.cpp:479-560)."""
    rng = np.random.default_rng(17)
    bases = "ACGT"
    true = "".join(bases[i] for i in rng.integers(0, 4, 40_000))

    def mutate(s, rate=0.03):
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

    warns = []
    outs = batched_consensus(
        [[mutate(true) for _ in range(3)]], rounds=1, warn=warns.append
    )
    cons = outs[0]
    assert len(cons) > 38_000
    k = 31
    tk = {true[i : i + k] for i in range(0, len(true) - k + 1, 7)}
    ck = {cons[i : i + k] for i in range(len(cons) - k + 1)}
    assert len(tk & ck) / len(tk) > 0.8


def test_oversized_window_warns_and_returns_draft():
    """Past the largest bucket the engine must degrade loudly, not
    silently emit an empty/truncated consensus."""
    rng = np.random.default_rng(18)
    s = "".join("ACGT"[i] for i in rng.integers(0, 4, 70_000))
    warns = []
    outs = batched_consensus([[s, s, s]], warn=warns.append)
    assert outs[0] == s
    assert any("beyond" in w for w in warns)


def test_batched_consensus_mixed_lengths():
    # windows of very different sizes exercise multiple buckets in one call
    rng = np.random.default_rng(9)
    bases = "ACGT"
    outs_expected = []
    windows = []
    for L in [40, 200, 700, 1500]:
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([true] * 5)
        outs_expected.append(true)
    outs = batched_consensus(windows)
    assert outs == outs_expected


def test_sorted_vote_tables_match_scatter():
    """The sort+RLE vote builder must produce bit-identical tables to the
    direct scatter builder for every table (counts/cov/ins1/ins2/n_reads),
    and the full dense engine must emit identical consensus either way."""
    import numpy as np

    from haslr_tpu.core import seq as cseq
    from haslr_tpu.kernels import consensus_dense as cd
    from haslr_tpu.kernels import nw

    rng = np.random.default_rng(3)
    N, S, W = 8, 256, 128
    B = 64
    # synthesize realistic mappings by aligning mutated reads to drafts
    drafts = rng.integers(0, 4, (N, S)).astype(np.uint8)
    d_lens = rng.integers(120, 250, N).astype(np.int32)
    reads = np.zeros((B, S), np.uint8)
    r_lens = np.zeros(B, np.int32)
    win_idx = rng.integers(0, N, B).astype(np.int32)
    for b in range(B):
        w = win_idx[b]
        src = list(drafts[w, : d_lens[w]])
        out = []
        for c in src:
            r = rng.random()
            if r < 0.03:
                continue
            out.append(int(rng.integers(0, 4)) if r < 0.06 else int(c))
            if r > 0.97:
                out.append(int(rng.integers(0, 4)))
                if r > 0.99:
                    out.append(int(rng.integers(0, 4)))
        out = out[:S]
        reads[b, : len(out)] = out
        r_lens[b] = len(out)
    ok = (r_lens > 0) & (np.abs(r_lens - d_lens[win_idx]) < W // 2 - 4)

    import jax.numpy as jnp

    mapping = nw._align_mapping_inner(
        jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(drafts[win_idx]), jnp.asarray(d_lens[win_idx]),
        S, S, W, 5, -4, -8, "wavefront",
    )
    a = cd._scatter_votes(
        mapping, jnp.asarray(reads), jnp.asarray(r_lens),
        jnp.asarray(win_idx), jnp.asarray(ok), N, S,
    )
    for alt_fn in (cd._scatter_votes_sorted, cd._scatter_votes_packed):
        b = alt_fn(
            mapping, jnp.asarray(reads), jnp.asarray(r_lens),
            jnp.asarray(win_idx), jnp.asarray(ok), N, S,
        )
        names = ["counts", "cov_diff", "ins1", "ins2", "n_reads"]
        for name, x, y in zip(names, a, b):
            np.testing.assert_array_equal(
                np.asarray(x), np.asarray(y),
                err_msg=f"{alt_fn.__name__}:{name}",
            )

    # end-to-end dense engine equality across implementations
    windows = []
    bases = "ACGT"
    for _ in range(17):
        L = int(rng.integers(60, 500))
        t = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append(
            [cseq.encode(t[: max(1, L - int(rng.integers(0, 9)))])
             for _ in range(7)]
        )
    old = cd.VOTE_IMPL
    try:
        cd.VOTE_IMPL = "scatter"
        r1 = cd.dense_consensus([list(w) for w in windows])
        cd.VOTE_IMPL = "sort"
        r2 = cd.dense_consensus([list(w) for w in windows])
        cd.VOTE_IMPL = "packed"
        r3 = cd.dense_consensus([list(w) for w in windows])
    finally:
        cd.VOTE_IMPL = old
    assert all(np.array_equal(x, y) for x, y in zip(r1, r2))
    assert all(np.array_equal(x, y) for x, y in zip(r1, r3))


def test_batch_padding_unit():
    """Consensus batches pad to B_UNIT x n_dev times a power of two (the
    row-scan DP takes any batch; every mesh device gets an equal shard),
    and the per-dispatch cap follows the direction-tensor budget."""
    from haslr_tpu.kernels import consensus_dense as cd

    for n_dev in (1, 4, 8):
        unit = cd.B_UNIT * n_dev
        for n in (1, 7, 8, 9, 100, 4097):
            B = cd._pad_batch(n, n_dev)
            q = B // unit
            assert B >= n and B % unit == 0 and q & (q - 1) == 0
            assert B < 2 * max(n, unit)
    assert cd.max_batch(512, 128) == (1 << 30) // (1025 * 128)
    assert cd.max_batch(16384, 512) == 64
    assert cd.max_batch(512, 128, 4) == 4 * cd.max_batch(512, 128)
    old = cd.MAX_B_OVERRIDE
    cd.MAX_B_OVERRIDE = 24
    try:
        assert cd.max_batch(512, 128, 4) == 24
    finally:
        cd.MAX_B_OVERRIDE = old
