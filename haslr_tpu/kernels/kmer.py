"""Device k-mer counting: pack, canonicalize, sort, segment-count.

The counting core of the minia replacement (reference pipeline stage
``minia -kmer-size 49 -abundance-min 3``, ``bin/haslr.py:180``), done the
data-parallel way: k-mers across the whole read batch are packed into (hi, lo)
uint32x4/uint64 lanes with static shift loops, canonicalized against their
reverse complements, sorted on device (two-key radix sort via
``jax.lax.sort``) and run-length encoded.  Abundance filtering happens on
the sorted output.

A numpy twin (:func:`count_kmers_host`) provides the identical result for
tests and small inputs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SEP = 4  # separator code between concatenated reads


def _pack_pair_np(codes: np.ndarray, k: int):
    """All k-mer (hi, lo) uint64 pairs + validity mask (numpy)."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, bool)
    m = n - k + 1
    hi = np.zeros(m, np.uint64)
    lo = np.zeros(m, np.uint64)
    c = codes.astype(np.uint64)
    k_lo = min(k, 32)
    k_hi = k - k_lo
    for j in range(k_hi):
        hi = (hi << np.uint64(2)) | (c[j : m + j] & np.uint64(3))
    for j in range(k_hi, k):
        lo = (lo << np.uint64(2)) | (c[j : m + j] & np.uint64(3))
    bad = (codes >= SEP).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return hi, lo, valid


def _revcomp_pair_np(hi, lo, k):
    """Reverse complement of (hi, lo) packed k-mers.

    The original stream is hi-bases (first k-k_lo) then lo-bases (last
    k_lo); the reverse complement emits complemented bases in reverse
    order, so collecting 2-bit groups lo-first/LSB-first yields the new
    stream front-to-back: the first ``k_hi`` collected groups refill rhi,
    the rest rlo.
    """
    k_lo = min(k, 32)
    k_hi = k - k_lo
    vals = []
    x = (~lo).copy()
    for _ in range(k_lo):
        vals.append(x & np.uint64(3))
        x >>= np.uint64(2)
    x = (~hi).copy()
    for _ in range(k_hi):
        vals.append(x & np.uint64(3))
        x >>= np.uint64(2)
    rhi = np.zeros_like(hi)
    for v in vals[:k_hi]:
        rhi = (rhi << np.uint64(2)) | v
    rlo = np.zeros_like(lo)
    for v in vals[k_hi:]:
        rlo = (rlo << np.uint64(2)) | v
    return rhi, rlo


def count_kmers_host(codes: np.ndarray, k: int, min_count: int = 1):
    """Canonical k-mer counts (numpy).  ``codes`` may contain SEP=4
    separators between reads.  Returns (hi, lo, count) sorted."""
    hi, lo, valid = _pack_pair_np(codes, k)
    hi, lo = hi[valid], lo[valid]
    rhi, rlo = _revcomp_pair_np(hi, lo, k)
    use_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    chi = np.where(use_rc, rhi, hi)
    clo = np.where(use_rc, rlo, lo)
    order = np.lexsort((clo, chi))
    chi, clo = chi[order], clo[order]
    if len(chi) == 0:
        return chi, clo, np.zeros(0, np.int64)
    new = np.concatenate(
        [[True], (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])]
    )
    starts = np.nonzero(new)[0]
    counts = np.diff(np.concatenate([starts, [len(chi)]]))
    keep = counts >= min_count
    return chi[starts][keep], clo[starts][keep], counts[keep]


def _word_spans(k: int):
    """Split k bases into <=16-base words (uint32 lanes, device-friendly)."""
    spans = []
    s = 0
    while s < k:
        spans.append((s, min(s + 16, k)))
        s += 16
    return spans


_SCAN_COLS = 1 << 13


def _cumsum_1d(x):
    """Inclusive int32 cumsum, 2D-TILED for large arrays: a direct 1-D
    scan at 10^8 elements unrolls into dozens of full-array HLO stages
    (very slow remote compiles); reshaping to (rows, 8192) does the lane-
    dim scan in 13 stages over 2D blocks plus one small row-offset scan."""
    m = x.shape[0]
    if m <= _SCAN_COLS * 4:
        return jnp.cumsum(x)
    rows = -(-m // _SCAN_COLS)
    pad = rows * _SCAN_COLS - m
    g = jnp.pad(x, (0, pad)).reshape(rows, _SCAN_COLS)
    within = jnp.cumsum(g, axis=1)
    row_tot = within[:, -1]
    offs = jnp.cumsum(row_tot) - row_tot
    return (within + offs[:, None]).reshape(-1)[:m]


def _rev_cummin_1d(x):
    """Reverse (suffix) min-scan: out[i] = min(x[i:]), tiled like
    :func:`_cumsum_1d`; pads with int32 max so the tail is neutral."""
    m = x.shape[0]
    if m <= _SCAN_COLS * 4:
        return jax.lax.cummin(x, axis=0, reverse=True)
    rows = -(-m // _SCAN_COLS)
    pad = rows * _SCAN_COLS - m
    INF = np.int32(2**31 - 1)
    g = jnp.pad(x, (0, pad), constant_values=INF) \
        .reshape(rows, _SCAN_COLS)
    within = jax.lax.cummin(g, axis=1, reverse=True)
    row_min = within[:, 0]
    # min over STRICTLY LATER rows: shift the suffix-min down by one
    later = jnp.concatenate(
        [jax.lax.cummin(row_min, axis=0, reverse=True)[1:],
         jnp.full(1, INF, row_min.dtype)]
    )
    return jnp.minimum(within, later[:, None]).reshape(-1)[:m]


def _rle_compact(sorted_words, n_valid, min_count, weights=None):
    """Run-length count + abundance filter + compaction of sorted word
    columns (device).  ``weights``: optional per-row counts (for merging
    pre-counted streams); default weight 1 per row.  Returns (compacted
    word columns, counts, n_distinct).

    GATHER-FREE by design: the original start-index gather + compaction
    scatter over the padded row count dominated the whole k-mer counter on
    the accelerator this was first written for.  Instead:

    - per-run totals come from the prefix-sum identity
      ``count(run) = C[run_end] - C[run_start - 1]`` where ``C`` is the
      weight cumsum; since ``C`` is nondecreasing, the end-of-run value
      seen from any row is a REVERSE MIN-SCAN of ``C`` masked to run-end
      rows — scans, shifts and elementwise ops only;
    - compaction to the front is ONE more single-key sort (kept rows get
      their output position as key, dropped rows sort last), which at
      134M rows costs ~1 s where the scatter path cost minutes.
    """
    m = sorted_words[0].shape[0]
    pos = jnp.arange(m, dtype=jnp.int32)
    valid = pos < n_valid
    new = jnp.zeros(m, bool).at[0].set(True)
    for w in sorted_words:
        new = new | jnp.concatenate([jnp.ones(1, bool), w[1:] != w[:-1]])
    new = new & valid
    wts = (
        weights.astype(jnp.int32)
        if weights is not None
        else jnp.ones(m, jnp.int32)
    )
    wts = jnp.where(valid, wts, 0)
    # C[i] = total weight up to row i; counts fit int32 because the
    # device-resident accumulator is bounded (device_rows_budget rows;
    # beyond that the caller spills to prefix partitions, each bounded)
    C = _cumsum_1d(wts)
    # run ends: the row before each new run start, plus the final row
    run_end = jnp.concatenate([new[1:], jnp.ones(1, bool)])
    INF = jnp.int32(2**31 - 1)
    end_c = jnp.where(run_end, C, INF)
    # reverse min-scan: for each row, the cumsum at ITS run's end (C is
    # nondecreasing, so min over later run-ends = own run's end)
    run_end_c = _rev_cummin_1d(end_c)
    run_counts = run_end_c - (C - wts)  # valid where ``new``
    keep = new & (run_counts >= min_count)
    out_idx = _cumsum_1d(keep.astype(jnp.int32)) - 1
    n_keep = out_idx[-1] + 1
    # compaction by sort: kept rows keyed by output position (already in
    # ascending k-mer order), everything else keyed last.  Non-kept rows
    # carry 0/0 payloads so the tail matches the old scatter layout
    # (callers slice [:n_keep]; tests compare padded tails).
    key = jnp.where(keep, out_idx.astype(jnp.uint32), jnp.uint32(m))
    payload = [jnp.where(keep, w, 0) for w in sorted_words]
    payload.append(jnp.where(keep, run_counts, 0))
    sorted_out = jax.lax.sort((key, *payload), num_keys=1)
    out_words = list(sorted_out[1:-1])
    out_counts = sorted_out[-1]
    return out_words, out_counts, n_keep


@functools.partial(jax.jit, static_argnums=(1,))
def _device_unique_counts(codes: jnp.ndarray, k: int, min_count):
    """Sort + run-length count + abundance filter + compaction, all on
    device; returns (compacted word columns, counts, n_distinct).

    Only the ``n_distinct`` prefix of the outputs is meaningful — callers
    fetch exactly that slice, keeping the device->host transfer
    proportional to the distinct solid k-mers (the raw sorted stream for a
    real read set would be hundreds of MB).
    """
    sorted_words, n_valid = _device_sorted_kmers(codes, k)
    return _rle_compact(sorted_words, n_valid, min_count)


@functools.partial(jax.jit, static_argnums=(1,))
def _device_sorted_kmers(codes: jnp.ndarray, k: int):
    """Canonical k-mers as uint32 word tuples, sorted on device.

    The device path keeps to 32-bit words, so a k-mer is 2k bits spread over
    ceil(k/16) uint32 lanes; canonicalization and the sort compare the
    word tuples lexicographically (== base-lexicographic order, the same
    order the host path uses).
    """
    n = codes.shape[0]
    m = n - k + 1
    c = codes.astype(jnp.uint32)
    spans = _word_spans(k)
    three = np.uint32(3)
    words = []
    for (b0, b1) in spans:
        w = jnp.zeros(m, jnp.uint32)
        for j in range(b0, b1):
            w = (w << np.uint32(2)) | (
                jax.lax.dynamic_slice(c, (j,), (m,)) & three
            )
        words.append(w)
    bad = (codes >= SEP).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    canon = _canonical_words(words, spans)
    FULL = np.uint32(0xFFFFFFFF)
    canon = [jnp.where(valid, w, FULL) for w in canon]
    sorted_words = jax.lax.sort(tuple(canon), num_keys=len(canon))
    return sorted_words, jnp.sum(valid.astype(jnp.int32))


def _canonical_words(words, spans):
    """Canonical (min of forward / reverse-complement) form of packed
    k-mer word columns (device)."""
    m = words[0].shape[0]
    three = np.uint32(3)
    # reverse complement: collect complemented 2-bit groups last-word
    # LSB-first; the stream refills the words front-to-back
    vals = []
    for w, (b0, b1) in zip(reversed(words), reversed(spans)):
        x = ~w
        for _ in range(b1 - b0):
            vals.append(x & three)
            x = x >> np.uint32(2)
    rwords = []
    pos = 0
    for (b0, b1) in spans:
        w = jnp.zeros(m, jnp.uint32)
        for v in vals[pos : pos + (b1 - b0)]:
            w = (w << np.uint32(2)) | v
        rwords.append(w)
        pos += b1 - b0
    # canonical = lexicographic min(fwd, rc)
    use_rc = jnp.zeros(m, jnp.bool_)
    undecided = jnp.ones(m, jnp.bool_)
    for w, rw in zip(words, rwords):
        use_rc = use_rc | (undecided & (rw < w))
        undecided = undecided & (rw == w)
    return [jnp.where(use_rc, rw, w) for w, rw in zip(words, rwords)]


def _words_to_pair(words: list, k: int):
    """Recombine uint32 word columns into the host (hi, lo) uint64 pair."""
    spans = _word_spans(k)
    hi = np.zeros(len(words[0]), np.uint64)
    lo = np.zeros(len(words[0]), np.uint64)
    for w, (b0, b1) in zip(words, spans):
        for nb in range(b1 - b0):
            base = (w.astype(np.uint64) >> np.uint64(2 * (b1 - b0 - 1 - nb))) \
                & np.uint64(3)
            hi = (hi << np.uint64(2)) | ((lo >> np.uint64(62)) & np.uint64(3))
            lo = (lo << np.uint64(2)) | base
    k_hi = max(0, k - 32)
    mask_hi = np.uint64((1 << (2 * k_hi)) - 1) if k_hi else np.uint64(0)
    return hi & mask_hi, lo


def count_kmers_device(codes: np.ndarray, k: int, min_count: int = 1):
    """Device-path canonical k-mer counting; same contract/output as
    :func:`count_kmers_host`."""
    if len(codes) < k:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, np.int64)
    # pad to power-of-two length with separators: stable jit shapes (every
    # new shape is a compile)
    n = 1024
    while n < len(codes):
        n *= 2
    if n != len(codes):
        codes = np.concatenate(
            [codes, np.full(n - len(codes), SEP, dtype=np.uint8)]
        )
    out_words, out_counts, n_keep = _device_unique_counts(
        jnp.asarray(codes), k, min_count
    )
    n = int(n_keep)
    if n == 0:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, np.int64)
    # fetch only the distinct-kmer prefix (device slicing keeps the
    # transfer proportional to the result, not the input)
    words = [np.asarray(w[:n]) for w in out_words]
    counts = np.asarray(out_counts[:n]).astype(np.int64)
    hi, lo = _words_to_pair(words, k)
    return hi, lo, counts


def merge_kmer_counts(parts, min_count: int = 1, prefix_bits: int = 6):
    """Merge per-shard canonical k-mer count streams (the multi-host SR
    counting path).

    ``parts``: iterable of ``(hi, lo, count)`` triples, each sorted by
    ``(hi, lo)`` — the output contract of :func:`count_kmers_host` /
    ``native.count_kmers_native`` — counted at ``min_count=1`` per shard
    (a k-mer can sit below the abundance threshold in every shard and
    above it globally; filtering happens HERE, after summation).  Returns
    the merged sorted ``(hi, lo, count)`` with ``count >= min_count``.

    Across hosts each host counts its read shard natively
    (``native/kmer.cpp``), the sorted shard streams
    are range-split by the k-mer's high bits (one ``searchsorted`` per
    shard — the (k-mer, count) all-to-all of SURVEY §2.3), and every host
    runs this merge over its own disjoint range; concatenating the range
    outputs in prefix order yields the global sorted stream.  The range
    loop below is that per-range merge: memory is bounded by the largest
    range, not the input.  (For k <= 32 every ``hi`` is 0 and the split
    degenerates to one range — the 64-bit ``lo`` keys could be range-split
    the same way if that ever matters; production k is 49.)
    """
    parts = [p for p in parts if len(p[0])]
    z = np.zeros(0, np.uint64)
    if not parts:
        return z, z, np.zeros(0, np.int64)

    if len(parts) > 1:
        # native single-pass k-way merge (each shard is already sorted;
        # the numpy path below re-sorts the concatenation)
        from haslr_tpu import native

        out = native.merge_kmer_native(parts, min_count)
        if out is not None:
            return out

    def _merge_range(chunks):
        hi = np.concatenate([c[0] for c in chunks])
        lo = np.concatenate([c[1] for c in chunks])
        cnt = np.concatenate([c[2] for c in chunks])
        order = np.lexsort((lo, hi))
        hi, lo, cnt = hi[order], lo[order], cnt[order]
        new = np.empty(len(hi), bool)
        new[0] = True
        np.not_equal(hi[1:], hi[:-1], out=new[1:])
        np.logical_or(new[1:], lo[1:] != lo[:-1], out=new[1:])
        starts = np.nonzero(new)[0]
        sums = np.add.reduceat(cnt, starts)
        keep = sums >= min_count
        return hi[starts][keep], lo[starts][keep], sums[keep].astype(
            np.int64
        )

    if len(parts) == 1:
        hi, lo, cnt = parts[0]
        keep = cnt >= min_count
        return hi[keep], lo[keep], cnt[keep].astype(np.int64)

    # range-split on the high bits of (hi) so peak memory is ~the largest
    # range, not the whole input; each part is sorted, so one searchsorted
    # per part finds its slice of every range
    n_ranges = 1 << prefix_bits
    k_hi_bits = max(
        int(p[0][-1]).bit_length() for p in parts
    )
    if k_hi_bits <= prefix_bits:
        return _merge_range(parts)
    shift = np.uint64(k_hi_bits - prefix_bits)
    edges = (np.arange(1, n_ranges, dtype=np.uint64) << shift)
    bounds = [
        np.concatenate(
            [[0], np.searchsorted(p[0], edges), [len(p[0])]]
        )
        for p in parts
    ]
    his, los, cnts = [], [], []
    for r in range(n_ranges):
        chunks = [
            (p[0][b[r] : b[r + 1]], p[1][b[r] : b[r + 1]],
             p[2][b[r] : b[r + 1]])
            for p, b in zip(parts, bounds)
            if b[r + 1] > b[r]
        ]
        if not chunks:
            continue
        h, l, c = _merge_range(chunks)
        his.append(h)
        los.append(l)
        cnts.append(c)
    if not his:
        return z, z, np.zeros(0, np.int64)
    return np.concatenate(his), np.concatenate(los), np.concatenate(cnts)
