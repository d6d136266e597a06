"""Streaming, scale-proof canonical k-mer counting (prefix-partitioned).

The single-shot device counter (:mod:`haslr_tpu.kernels.kmer`) pads the
whole concatenated read stream to one power-of-two device array — fine for
E. coli, structurally impossible for CHM1-scale inputs (100+ Gbp of short
reads vs ~16 GB of HBM).  This module is the external-memory design that
replaces minia's disk-based KMC-style counter (reference invocation
``bin/haslr.py:180``) at any input size with BOUNDED device and host
memory:

1. **Distribute** — reads stream through the chip in fixed-size chunks
   (2-bit packed on host, one H2D transfer per chunk); each chunk's
   k-mers are packed/canonicalized/sorted/run-length-collapsed on device
   (coverage within a chunk collapses ~C× before anything returns to
   host), and the per-chunk distinct (k-mer, count) rows are split by the
   top ``2*prefix_bits`` bits of the canonical k-mer into 4^p partition
   buffers (optionally spilled to disk).
2. **Count** — partitions are processed one at a time: rows from all
   chunks are merged with one more device sort keyed by the k-mer words,
   counts summed by segment, abundance-filtered.  Since partitions are
   prefix-ordered and each is internally sorted, concatenating the
   partition outputs yields the globally sorted (hi, lo, count) stream —
   the same contract as ``count_kmers_host`` / ``count_kmers_device``.

Multi-chip scaling: partitions are disjoint by construction, so chips
count disjoint prefix ranges with no collective at all; the host-sharded
read stream only needs an all-to-all of (k-mer, count) rows keyed by
prefix, which this layout makes a pure concatenation.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from haslr_tpu.kernels.kmer import (
    _canonical_words,
    _rle_compact,
    _word_spans,
    _words_to_pair,
)

FULL = np.uint32(0xFFFFFFFF)

# host-side wall-clock accounting of the last count_kmers_streaming call
# (phase1_pack / phase1_device / phase2_device / split); PROF.clear() to
# reset — mirrors consensus_dense.PROF
PROF: dict[str, float] = {}


def _prof(key, dt):
    PROF[key] = PROF.get(key, 0.0) + dt


def pack2(codes: np.ndarray) -> np.ndarray:
    """2-bit pack (4 codes/byte, LSB-first) for the host->device hop."""
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    g = (codes & 3).reshape(-1, 4)
    return (g[:, 0] | (g[:, 1] << 2) | (g[:, 2] << 4) | (g[:, 3] << 6)) \
        .astype(np.uint8)


@functools.partial(jax.jit, static_argnums=(2, 4))
def _count_chunk(packed, offsets, k, min_count, n_off_pad):
    """Distinct canonical k-mer counts of one packed chunk (device).

    ``offsets``: int32 read-boundary offsets (0, ends...), padded by
    repeating the total length to a static size — k-mers crossing a
    boundary (or in the pad tail) are invalidated via a searchsorted
    check, so no separator codes are needed and the input stays 2 bits
    per base.  Returns (sorted word columns, counts, n_distinct)."""
    nbytes = packed.shape[0]
    n = nbytes * 4
    b = packed.astype(jnp.uint32)
    codes = jnp.stack(
        [b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], axis=1
    ).reshape(n)
    m = n - k + 1
    spans = _word_spans(k)
    three = np.uint32(3)
    words = []
    for (b0, b1) in spans:
        w = jnp.zeros(m, jnp.uint32)
        for j in range(b0, b1):
            w = (w << np.uint32(2)) | (
                jax.lax.dynamic_slice(codes, (j,), (m,)) & three
            )
        words.append(w)
    # a k-mer starting at i is valid iff no read boundary falls strictly
    # inside (i, i+k) and i+k is within the real data.  searchsorted would
    # binary-search all m positions (17 gather passes of m elements); a
    # boundary-flag cumsum gives the same mask with one tiny scatter, one
    # scan and two contiguous slices
    total = offsets[n_off_pad - 1]
    # no clip: an offset == n (data exactly filling the array) has no
    # k-mer crossing it and must NOT alias onto position n-1 — mode="drop"
    # discards out-of-range offsets outright
    flags = jnp.zeros(n, jnp.int32).at[offsets].set(1, mode="drop")
    csum = jnp.cumsum(flags)
    i = jnp.arange(m, dtype=jnp.int32)
    inner = jax.lax.dynamic_slice(csum, (k - 1,), (m,)) - csum[:m]
    valid = (inner == 0) & (i + k <= total)
    canon = _canonical_words(words, spans)
    canon = [jnp.where(valid, w, FULL) for w in canon]
    sorted_words = jax.lax.sort(tuple(canon), num_keys=len(canon))
    return _rle_compact(sorted_words, jnp.sum(valid.astype(jnp.int32)),
                        min_count)


@jax.jit
def _merge_sort(words_stack, counts):
    """The sort half of the partition merge (own program — see below)."""
    cols = tuple(words_stack[i] for i in range(words_stack.shape[0]))
    return jax.lax.sort(cols + (counts,), num_keys=len(cols))


@functools.partial(jax.jit, static_argnums=(2,))
def _merge_rle(sorted_all, n_rows, min_count):
    """The RLE half of the partition merge (own program — see below)."""
    sorted_words = list(sorted_all[:-1])
    sorted_counts = sorted_all[-1]
    return _rle_compact(sorted_words, n_rows, min_count,
                        weights=sorted_counts)


def _merge_partition(words_stack, counts, n_rows, min_count):
    """Merge pre-counted rows (device): sort by k-mer words, sum counts of
    equal k-mers, abundance-filter.  ``words_stack``: (n_words, m); the
    ``m - n_rows`` pad rows are all-FULL on every word, which no canonical
    k-mer can be (the canonical form of T^k is A^k), so they sort strictly
    last and the ``n_rows`` prefix of the sorted stream is exactly the
    real rows.

    Deliberately TWO dispatches, not one fused jit: the sort and the RLE
    compaction each run at full speed as separate programs, but XLA's
    fusion of sort -> scans -> compaction-sort into one program ran many
    times slower on the accelerator this was first written for — the
    fused schedule defeats the fast sort path.  The intermediate stays
    on device; the extra dispatch costs ~30 ms.  (Inside jit/shard_map
    callers the two programs inline back into one — the sharded merge
    operates at per-device partition sizes where the pathology is not
    material.)"""
    sorted_all = _merge_sort(words_stack, counts)
    return _merge_rle(tuple(sorted_all), n_rows, min_count)


def _pow2(n: int, floor: int = 1024) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


@functools.partial(jax.jit, static_argnums=(0, 1))
def _acc_alloc(n_rows_dim, cap):
    """Device row accumulator: all-FULL word rows (sort strictly last in
    any merge — no canonical k-mer is all-FULL), zero counts row."""
    acc = jnp.full((n_rows_dim, cap), FULL, jnp.uint32)
    return acc.at[-1].set(0)


@functools.partial(jax.jit, donate_argnums=(0,))
def _acc_insert(acc, words, counts, n_keep, offset):
    """Insert one chunk's compacted rows at ``offset`` (device-resident;
    nothing is materialized).  Rows past ``n_keep`` are re-masked to the
    FULL/0 pad pattern (the chunk kernel's compaction leaves zeros
    there, which would sort first and corrupt the merge)."""
    stack = jnp.stack(list(words))
    m = stack.shape[1]
    live = jnp.arange(m) < n_keep
    wmask = jnp.where(live[None, :], stack, FULL)
    cmask = jnp.where(live, counts.astype(jnp.uint32), 0)
    block = jnp.concatenate([wmask, cmask[None]], axis=0)
    return jax.lax.dynamic_update_slice(acc, block, (0, offset))




@functools.lru_cache(maxsize=None)
def _make_sharded_merge(mesh, n_words, M, min_count):
    """shard_mapped phase-2 merge: each device merges ONE partition of the
    group (prefix partitions are disjoint by construction, so there is no
    collective — SURVEY §2.3's multi-chip k-mer mapping: the only cross-
    device exchange is the host-side prefix split, which in a multi-host
    deployment becomes the (k-mer, count) all-to-all keyed by prefix)."""
    from jax.sharding import PartitionSpec as P

    def _one(stack, n_rows):
        # local shard: (1, n_words+1, M) rows + (1,) real row count
        out_words, out_counts, n_keep = _merge_partition(
            stack[0, :-1], stack[0, -1], n_rows[0], min_count
        )
        return (
            jnp.stack(list(out_words))[None],
            out_counts[None],
            n_keep[None].astype(jnp.int32),
        )

    sm = jax.shard_map(
        _one,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp")),
    )
    return jax.jit(sm)


class _PartitionStore:
    """Per-partition (words, counts) row buffers, RAM or disk-backed."""

    def __init__(self, n_parts: int, n_words: int, spill_dir=None):
        self.n_parts = n_parts
        self.n_words = n_words
        self.spill_dir = spill_dir
        self.mem: list[list[np.ndarray]] = [[] for _ in range(n_parts)]
        self.files: list[list[str]] = [[] for _ in range(n_parts)]
        self._file_no = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def add(self, pid: int, rows: np.ndarray):
        if rows.shape[1] == 0:
            return
        if self.spill_dir:
            path = os.path.join(
                self.spill_dir, f"part{pid}_{self._file_no}.npy"
            )
            self._file_no += 1
            np.save(path, rows)
            self.files[pid].append(path)
        else:
            self.mem[pid].append(rows)

    def take(self, pid: int) -> np.ndarray:
        """All rows of one partition, concatenated; frees the buffers."""
        chunks = list(self.mem[pid])
        for path in self.files[pid]:
            chunks.append(np.load(path))
            os.remove(path)
        self.mem[pid] = []
        self.files[pid] = []
        if not chunks:
            return np.zeros((self.n_words + 1, 0), np.uint32)
        return np.concatenate(chunks, axis=1)


def count_kmers_streaming(
    reads,
    k: int,
    min_count: int = 1,
    chunk_bases: int = 1 << 24,
    prefix_bits: int = 4,
    spill_dir: str | None = None,
    mesh=None,
    device_rows_budget: int = 1 << 27,
):
    """Canonical k-mer counts over an iterable of read code arrays.

    Same output contract as ``count_kmers_host``: (hi, lo, counts), the
    distinct canonical k-mers in sorted order with count >= min_count.

    Two regimes.  While the accumulated per-chunk rows fit
    ``device_rows_budget`` (and no mesh/spill is requested), everything
    stays DEVICE-RESIDENT: chunk rows append into a fixed-capacity HBM
    accumulator and one final device sort merges them — only the final
    distinct rows ever cross the host link.  Beyond the budget — or with
    ``spill_dir`` or ``mesh`` — rows fall back to the prefix-partitioned
    host/disk store with bounded memory at any scale.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis — phase 2
    then merges ``n_devices`` prefix partitions at a time, one partition
    per device (disjoint prefix ranges: no collective), with bit-identical
    output to the single-device path."""
    spans = _word_spans(k)
    n_words = len(spans)
    first_word_bases = spans[0][1] - spans[0][0]
    prefix_bits = min(prefix_bits, first_word_bases)
    shift = np.uint32(2 * first_word_bases - 2 * prefix_bits)
    n_parts = 1 << (2 * prefix_bits)
    store = _PartitionStore(n_parts, n_words, spill_dir)

    # --- device-resident accumulator state ------------------------------
    device_mode = spill_dir is None and mesh is None
    acc = None
    acc_cap = 0
    acc_off = 0  # rows consumed (incl. chunk pad rows)
    acc_keeps: list = []  # device n_keep scalars, summed lazily
    acc_segs: list[tuple[int, int]] = []  # (offset, m) per inserted chunk
    max_cap = 1 << (max(device_rows_budget, 2).bit_length() - 1)

    # ---- phase 1: distribute ------------------------------------------
    # flush() only DISPATCHES the chunk kernel; results are collected
    # later (bounded in-flight queue) so the host-side read streaming and
    # 2-bit packing of the next chunk overlap the device sort of the
    # previous one instead of serializing on the round trip
    buf: list[np.ndarray] = []
    buf_len = 0
    in_flight: list[tuple] = []

    def _store_rows(rows):
        """Split one chunk's sorted rows by prefix into the host store."""
        pids = rows[0] >> shift
        bounds = np.searchsorted(pids, np.arange(n_parts + 1))
        for pid in range(n_parts):
            lo_i, hi_i = bounds[pid], bounds[pid + 1]
            if hi_i > lo_i:
                store.add(pid, rows[:, lo_i:hi_i])

    def _spill_acc_to_host():
        """Budget exceeded: materialize the accumulated device segments
        into the host partition store and continue in host mode."""
        nonlocal device_mode, acc
        import time as _time

        _t0 = _time.time()
        host = np.asarray(acc)
        keeps = [int(nkd) for nkd in acc_keeps]
        for (off, m), nk in zip(acc_segs, keeps):
            if nk:
                _store_rows(host[:, off : off + nk])
        acc = None
        device_mode = False
        _prof("acc_spill", _time.time() - _t0)

    def _self_compact():
        """Merge the accumulator in place (sort + RLE at min_count=1):
        acc_off shrinks to ~the distinct row count so far, so the device
        path scales to any input whose DISTINCT k-mers fit the budget.

        The re-insert slices at the FIXED shape acc_cap//2 (one compiled
        program, not one per distinct-row count); if the distinct rows
        exceed that, the caller's budget check spills to the host
        partition store."""
        nonlocal acc, acc_off
        import time as _time

        _t0 = _time.time()
        real = int(sum(int(nkd) for nkd in acc_keeps))
        ow, oc, nk2 = _merge_partition(
            acc[:-1], acc[-1], np.int32(real), 1
        )
        nk2i = int(nk2)
        nkp = acc_cap // 2
        if nk2i > nkp:
            # distinct rows no longer fit half the budget: leave the
            # merged rows where they are and let the budget check spill
            acc_keeps.clear()
            acc_keeps.append(np.int32(nk2i))
            acc_segs.clear()
            acc_segs.append((0, acc_cap))
            acc = _acc_insert(
                _acc_alloc(n_words + 1, acc_cap),
                tuple(ow), oc, nk2, np.int32(0),
            )
            acc_off = acc_cap
            _prof("acc_compact", _time.time() - _t0)
            return
        acc = _acc_insert(
            _acc_alloc(n_words + 1, acc_cap),
            tuple(w[:nkp] for w in ow), oc[:nkp], nk2,
            np.int32(0),
        )
        acc_keeps.clear()
        acc_keeps.append(np.int32(nk2i))
        acc_segs.clear()
        acc_segs.append((0, nkp))
        acc_off = nkp
        _prof("acc_compact", _time.time() - _t0)

    def collect_one():
        import time as _time

        nonlocal acc, acc_cap, acc_off
        out_words, out_counts, n_keep = in_flight.pop(0)
        if device_mode:
            _t0 = _time.time()
            m = out_words[0].shape[0]
            cap_now = acc_cap if acc is not None else max_cap
            if acc_off + m > cap_now and acc is not None:
                _prof("phase1_acc", _time.time() - _t0)
                _self_compact()
                _t0 = _time.time()
            if acc_off + m > cap_now:
                # even compacted, the distinct rows exceed the budget
                _prof("phase1_acc", _time.time() - _t0)
                _spill_acc_to_host()
            else:
                if acc is None:
                    # ONE allocation, sized once: on this platform every
                    # distinct program shape costs ~a minute of first-
                    # call overhead per process (even compile-cached),
                    # so the historical doubling grow chain (alloc/grow
                    # per cap) was far more expensive than the memory it
                    # saved.  16 chunks of headroom before the first
                    # self-compact, clamped to the budget.
                    acc_cap = min(max_cap, _pow2(16 * m))
                    acc = _acc_alloc(n_words + 1, acc_cap)
                acc = _acc_insert(
                    acc, tuple(out_words), out_counts, n_keep,
                    np.int32(acc_off),
                )
                acc_keeps.append(n_keep)
                acc_segs.append((acc_off, m))
                acc_off += m
                _prof("phase1_acc", _time.time() - _t0)
                return
        _t0 = _time.time()
        nk = int(n_keep)
        _prof("phase1_device", _time.time() - _t0)
        if nk == 0:
            return
        _t0 = _time.time()
        nkp = min(_pow2(nk, 1024), out_words[0].shape[0])
        rows = np.stack(
            [np.asarray(w[:nkp])[:nk] for w in out_words]
            + [np.asarray(out_counts[:nkp])[:nk].astype(np.uint32)]
        )
        _store_rows(rows)
        _prof("phase1_d2h_split", _time.time() - _t0)

    n_flushed = 0
    off_floor = 64

    def flush():
        import time as _time

        nonlocal buf, buf_len, n_flushed, off_floor
        if not buf:
            return
        _t0 = _time.time()
        codes = np.concatenate(buf)
        offsets = np.zeros(len(buf) + 1, np.int64)
        np.cumsum([len(b) for b in buf], out=offsets[1:])
        buf, buf_len = [], 0
        # ONE padded shape for every chunk of a multi-chunk run (incl.
        # the final partial chunk): each distinct shape is a distinct
        # compiled program, and first-call program overhead on this
        # platform (~a minute each, even compile-cached) dwarfs the
        # wasted sort slots
        n_pad = (
            _pow2(max(len(codes) + 4, chunk_bases))
            if n_flushed > 0
            else _pow2(len(codes) + 4)
        )
        n_flushed += 1
        packed = pack2(codes)
        packed = np.concatenate(
            [packed, np.zeros(n_pad // 4 - len(packed), np.uint8)]
        )
        n_off = _pow2(len(offsets), off_floor)
        off_floor = max(off_floor, n_off)
        off_pad = np.full(n_off, offsets[-1], np.int32)
        off_pad[: len(offsets)] = offsets
        in_flight.append(_count_chunk(
            jnp.asarray(packed), jnp.asarray(off_pad), k, 1, n_off
        ))
        _prof("phase1_pack_dispatch", _time.time() - _t0)
        while len(in_flight) > 2:
            collect_one()

    for codes in reads:
        if len(codes) < k:
            continue
        # flush BEFORE the read that would overflow: a chunk that lands
        # just past chunk_bases pads to the NEXT power of two, making
        # half the device sort slots garbage (2x the sort cost)
        if buf_len and buf_len + len(codes) + 4 > chunk_bases:
            flush()
        buf.append(np.asarray(codes, np.uint8))
        buf_len += len(codes)
    flush()
    while in_flight:
        collect_one()

    # ---- phase 2: per-partition merge ---------------------------------
    his, los, cnts = [], [], []

    def emit(out_words, out_counts, nk):
        if nk == 0:
            return
        # slice at a power-of-two shape, trim on host: exact-size device
        # slices would mint one compiled program per distinct row count
        nkp = min(_pow2(nk, 1024), out_words[0].shape[0])
        words = [np.asarray(w[:nkp])[:nk] for w in out_words]
        counts = np.asarray(out_counts[:nkp])[:nk].astype(np.int64)
        hi, lo = _words_to_pair(words, k)
        his.append(hi)
        los.append(lo)
        cnts.append(counts)

    if device_mode:
        # one device sort over the resident accumulator; the only D2H is
        # the final distinct rows
        import time as _time

        _t0 = _time.time()
        if acc is None:
            z = np.zeros(0, np.uint64)
            return z, z, np.zeros(0, np.int64)
        real = int(sum(int(nkd) for nkd in acc_keeps))
        out_words, out_counts, n_keep = _merge_partition(
            acc[:-1], acc[-1], np.int32(real), min_count
        )
        emit(out_words, out_counts, int(n_keep))
        _prof("phase2_merge", _time.time() - _t0)
    elif mesh is None:
        # batch CONSECUTIVE partitions into one device sort per ~group_rows
        # rows: partition p's k-mers all precede partition p+1's, so a
        # joint sort of a prefix-contiguous group emits the same globally
        # sorted stream while the round trips (and the compiled mp shape
        # census) drop from n_parts to a handful
        group_rows = 1 << 23
        pending_rows: list[np.ndarray] = []
        pending_m = 0

        def merge_pending():
            import time as _time

            nonlocal pending_rows, pending_m
            if pending_m == 0:
                return
            _t0 = _time.time()
            rows = (
                pending_rows[0]
                if len(pending_rows) == 1
                else np.concatenate(pending_rows, axis=1)
            )
            pending_rows, pending_m = [], 0
            m = rows.shape[1]
            mp = _pow2(m, 1024)
            padded = np.full((n_words + 1, mp), FULL, np.uint32)
            padded[:, :m] = rows
            padded[-1, m:] = 0
            out_words, out_counts, n_keep = _merge_partition(
                jnp.asarray(padded[:-1]), jnp.asarray(padded[-1]), m,
                min_count,
            )
            emit(out_words, out_counts, int(n_keep))
            _prof("phase2_merge", _time.time() - _t0)

        for pid in range(n_parts):
            rows = store.take(pid)
            if rows.shape[1] == 0:
                continue
            if pending_m and pending_m + rows.shape[1] > group_rows:
                merge_pending()
            pending_rows.append(rows)
            pending_m += rows.shape[1]
        merge_pending()
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = int(mesh.devices.size)
        for lo_pid in range(0, n_parts, n_dev):
            group = [
                store.take(pid)
                for pid in range(lo_pid, min(lo_pid + n_dev, n_parts))
            ]
            while len(group) < n_dev:
                group.append(np.zeros((n_words + 1, 0), np.uint32))
            ms = [g.shape[1] for g in group]
            if not any(ms):
                continue
            mp = _pow2(max(ms), 1024)
            padded = np.full((n_dev, n_words + 1, mp), FULL, np.uint32)
            for d, g in enumerate(group):
                padded[d, :, : g.shape[1]] = g
                padded[d, -1, g.shape[1]:] = 0
            fn = _make_sharded_merge(mesh, n_words, mp, min_count)
            w_all, c_all, k_all = fn(
                jax.device_put(padded, NamedSharding(mesh, P("dp"))),
                jax.device_put(
                    np.asarray(ms, np.int32), NamedSharding(mesh, P("dp"))
                ),
            )
            w_all = np.asarray(w_all)
            c_all = np.asarray(c_all)
            k_all = np.asarray(k_all)
            for d in range(n_dev):
                emit(list(w_all[d]), c_all[d], int(k_all[d]))
    if not his:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, np.int64)
    return (
        np.concatenate(his),
        np.concatenate(los),
        np.concatenate(cnts),
    )
