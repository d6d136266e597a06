"""Base-level extension: turn an anchor chain into a full CIGAR.

Between consecutive exact-match anchors, diagonal stretches become M runs;
off-diagonal gaps are filled with a global NW alignment (vectorized numpy
rows with the closed-form insertion scan, same trick as the POA engine).
The result is a PAF-ready (ops, lens) CIGAR over the span from the first
to the last anchor, plus match statistics for the PAF n_match column.
"""

from __future__ import annotations

import numpy as np

from haslr_tpu.core import cigar as ccigar



NEG_H = -(10**12)

# per-phase wall clock of the last batch_align_segments call (pack /
# dispatch / collect_d2h / convert / host_small); merged into
# aligner.map.PROF under "extend." keys
PROF: dict[str, float] = {}


_downcast_jit = None


def _downcast_i16(m):
    global _downcast_jit
    if _downcast_jit is None:
        import jax
        import jax.numpy as jnp

        _downcast_jit = jax.jit(lambda x: x.astype(jnp.int16))
    return _downcast_jit(m)


def nw_cigar(a: np.ndarray, b: np.ndarray, match=2, mismatch=-4, gap=-2,
             band=64):
    """Banded global alignment of two code arrays; returns (ops, lens,
    n_eq).

    ``a`` plays the query (I consumes a), ``b`` the target (D consumes b).
    The band follows the main diagonal with half-width ``band`` plus the
    length difference, so it is exact whenever the optimal path drifts
    less than ``band`` off-diagonal (and fully exact when the band covers
    the whole matrix).
    """
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), 0
    if la == 0:
        return (np.array([ccigar.D], np.uint8), np.array([lb], np.int64), 0)
    if lb == 0:
        return (np.array([ccigar.I], np.uint8), np.array([la], np.int64), 0)
    W = min(lb + 1, abs(la - lb) + 2 * band + 1)
    # row i covers columns [offs[i], offs[i] + W)
    offs = np.clip(
        (np.arange(la + 1) * lb) // la - W // 2, 0, max(0, lb + 1 - W)
    )
    ks = np.arange(W, dtype=np.int64)
    H = np.empty((la + 1, W), dtype=np.int64)
    j0 = offs[0] + ks  # == ks
    H[0] = np.where(j0 <= lb, gap * j0, NEG_H)
    pad = np.full(W + 2, NEG_H, dtype=np.int64)
    for i in range(1, la + 1):
        shift = offs[i] - offs[i - 1]
        j = offs[i] + ks
        pad[1 : W + 1] = H[i - 1]
        # neighbor windows: prev index k + shift (up), k + shift - 1 (diag);
        # out-of-band indices land on the NEG_H pad cells
        up = pad[np.clip(ks + shift, -1, W) + 1]
        diag = pad[np.clip(ks + shift - 1, -1, W) + 1]
        jb = np.clip(j - 1, 0, lb - 1)
        sub = np.where(b[jb] == a[i - 1], match, mismatch)
        valid_j = (j <= lb)
        tmp = np.maximum(
            np.where(j >= 1, diag + sub, NEG_H),
            up + gap,
        )
        # in-row insertion chain within the band window
        row = gap * j + np.maximum.accumulate(tmp - gap * j)
        H[i] = np.where(valid_j, np.maximum(tmp, row), NEG_H)
    # traceback
    ops = []
    i, j = la, lb
    n_eq = 0
    while i > 0 or j > 0:
        k = j - offs[i]
        h = H[i][k]
        moved = False
        if i > 0 and j > 0:
            kp = j - 1 - offs[i - 1]
            if 0 <= kp < W and h == H[i - 1][kp] + (
                match if a[i - 1] == b[j - 1] else mismatch
            ):
                ops.append(ccigar.M)
                n_eq += int(a[i - 1] == b[j - 1])
                i -= 1
                j -= 1
                moved = True
        if not moved and i > 0:
            kp = j - offs[i - 1]
            if 0 <= kp < W and h == H[i - 1][kp] + gap:
                ops.append(ccigar.I)
                i -= 1
                moved = True
        if not moved:
            if j > 0 and (i == 0 or j - 1 - offs[i] >= 0):
                ops.append(ccigar.D)
                j -= 1
            else:
                # band edge: force the remaining moves
                ops.append(ccigar.I if i > 0 else ccigar.D)
                if i > 0:
                    i -= 1
                else:
                    j -= 1
    ops.reverse()
    o, l = ccigar.normalize(
        np.array(ops, dtype=np.uint8),
        np.ones(len(ops), dtype=np.int64),
    )
    return o, l, n_eq


def mapping_to_cigar(m: np.ndarray, q_codes: np.ndarray,
                     t_codes: np.ndarray):
    """Convert a device alignment mapping row to (ops, lens, n_eq).

    ``m[i]`` is the draft position of read base i (or ``-(a+3)`` for an
    insertion after draft position a) as produced by
    :func:`haslr_tpu.kernels.nw.align_mapping_device`; the global
    alignment consumes all of both sequences.  Fully vectorized: every
    read position expands to an optional D run plus one M/I column, then
    ``cigar.normalize`` merges runs and drops zero-length ops.
    """
    L = len(q_codes)
    d_len = len(t_codes)
    if L == 0:
        if d_len == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64), 0
        return (np.array([ccigar.D], np.uint8),
                np.array([d_len], np.int64), 0)
    mm = m[:L].astype(np.int64)
    diag = mm >= 0
    j_vals = np.where(diag, mm, -1)
    prev_j = np.maximum.accumulate(np.concatenate([[-1], j_vals]))[:-1]
    d_before = np.where(diag, j_vals - prev_j - 1, 0)
    # per position: [D run][M or I]
    ops = np.empty(2 * L + 1, dtype=np.uint8)
    lens = np.empty(2 * L + 1, dtype=np.int64)
    ops[0::2][:L] = ccigar.D
    lens[0::2][:L] = d_before
    ops[1::2] = np.where(diag, ccigar.M, ccigar.I).astype(np.uint8)
    lens[1::2] = 1
    last_j = int(j_vals.max()) if diag.any() else -1
    ops[-1] = ccigar.D
    lens[-1] = d_len - 1 - last_j
    n_eq = int(
        np.sum(q_codes[diag] == t_codes[np.clip(j_vals[diag], 0, d_len - 1)])
    )
    return ccigar.normalize(ops, lens) + (n_eq,)


def batch_align_segments(segments, match=2, mismatch=-4, gap=-2,
                         mesh=None):
    """Globally align many (q_codes, t_codes) segment pairs on device.

    Segments are length-bucketed and run through the batched banded-NW
    kernel (the same engine as window consensus); pairs whose length
    difference exceeds the band fall back to the host banded NW.  Returns
    a list of (ops, lens, n_eq) parallel to ``segments``.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis — each
    chunk's rows then split across the mesh (rows are independent, no
    collective), so several devices map reads with every one busy (minimap2's
    role, reference ``bin/haslr.py:99``).
    """
    import time as _time

    from haslr_tpu.kernels import nw as knw

    n_dev = 1 if mesh is None else int(mesh.devices.size)
    PROF.clear()

    def _prof(key, dt):
        PROF[key] = PROF.get(key, 0.0) + dt

    _t0 = _time.time()
    results = [None] * len(segments)
    buckets = {}
    for i, (q, t) in enumerate(segments):
        lq, lt = len(q), len(t)
        if lq == 0 or lt == 0 or max(lq, lt) < 16:
            results[i] = nw_cigar(q, t, match, mismatch, gap)
            continue
        S = 128
        while S < max(lq, lt):
            S *= 2
        W = 128 if S <= 1024 else (256 if S <= 2048 else 512)
        if abs(lq - lt) >= W // 2 - 4 or S > 16384:
            results[i] = nw_cigar(q, t, match, mismatch, gap)
            continue
        buckets.setdefault(S, []).append(i)
    _prof("host_small", _time.time() - _t0)
    from haslr_tpu import native

    # CIGAR runs come straight from the device traceback under the
    # row-scan engine: the D2H payload is one packed uint16 per CIGAR run
    # instead of one int16 per draft column
    use_runs = knw._resolve_engine(None) == "rowscan"

    # submit every chunk asynchronously (jax arrays are futures: uploads,
    # DPs and tracebacks of later chunks overlap earlier transfers), then
    # collect + convert
    in_flight = []
    for S, idxs in sorted(buckets.items()):
        # sort by total length: neighbouring kernel blocks then finish at
        # similar times
        idxs = sorted(
            idxs, key=lambda i: len(segments[i][0]) + len(segments[i][1])
        )
        W = 128 if S <= 1024 else (256 if S <= 2048 else 512)
        # power-of-two chunk size so every full chunk reuses ONE compiled
        # shape per bucket (the persistent cache then covers later runs)
        max_b = 32
        while max_b * 2 * (2 * S + 1) * W <= (256 << 20):
            max_b *= 2
        for lo in range(0, len(idxs), max_b):
            chunk = idxs[lo : lo + max_b]
            B = 32 * n_dev
            while B < len(chunk):
                B *= 2
            _t0 = _time.time()
            reads = np.full((B, S), 4, dtype=np.uint8)
            drafts = np.full((B, S), 4, dtype=np.uint8)
            r_lens = np.zeros(B, dtype=np.int32)
            d_lens = np.zeros(B, dtype=np.int32)
            for k, i in enumerate(chunk):
                q, t = segments[i]
                reads[k, : len(q)] = q
                drafts[k, : len(t)] = t
                r_lens[k] = len(q)
                d_lens[k] = len(t)
            _prof("pack", _time.time() - _t0)
            _t0 = _time.time()
            if use_runs:
                from haslr_tpu.kernels import nw_rowscan as rsk

                if mesh is None:
                    dev = rsk.cigar_runs_device_raw(
                        reads, r_lens, drafts, d_lens, W, match, mismatch,
                        gap,
                    )
                else:
                    dev = rsk.cigar_runs_device_sharded(
                        reads, r_lens, drafts, d_lens, mesh, W, match,
                        mismatch, gap,
                    )
                in_flight.append(
                    ("runs", chunk, dev, reads, drafts, r_lens, d_lens)
                )
            else:
                if mesh is None:
                    mapping_dev = knw.align_mapping_device_raw(
                        reads, r_lens, drafts, d_lens, W, match, mismatch,
                        gap,
                    )
                else:
                    mapping_dev = knw.align_mapping_device_sharded(
                        reads, r_lens, drafts, d_lens, mesh, W, match,
                        mismatch, gap,
                    )
                # int16 is lossless (values in [-(S+2), S), S <= 16384)
                # and halves the device->host transfer
                mapping_dev = _downcast_i16(mapping_dev)
                in_flight.append(
                    ("map", chunk, mapping_dev, reads, drafts, r_lens,
                     d_lens)
                )
            _prof("dispatch", _time.time() - _t0)
    for kind, chunk, dev, reads, drafts, r_lens, d_lens in in_flight:
        if kind == "runs":
            runs_dev, nruns_dev = dev
            _t0 = _time.time()
            runs = np.asarray(runs_dev)
            nruns = np.asarray(nruns_dev)
            _prof("collect_d2h", _time.time() - _t0)
            _t0 = _time.time()
            n = len(chunk)
            rows = native.runs_cigars_native(
                runs[:n], nruns[:n], reads[:n], drafts[:n], r_lens[:n],
                d_lens[:n],
            )
            if rows is None:
                rows = [
                    _decode_runs_py(runs[k], int(nruns[k]), *segments[i])
                    for k, i in enumerate(chunk)
                ]
            n_fallback = 0
            for k, i in enumerate(chunk):
                o, l, ne = rows[k]
                if ne < 0:  # run-count overflow / malformed: realign
                    results[i] = nw_cigar(*segments[i], match, mismatch,
                                          gap)
                    n_fallback += 1
                else:
                    results[i] = (o, l, ne)
            if n_fallback:
                _prof("n_runs_overflow", n_fallback)
            _prof("convert", _time.time() - _t0)
            continue
        mapping_dev = dev
        _t0 = _time.time()
        mapping = np.asarray(mapping_dev)
        _prof("collect_d2h", _time.time() - _t0)
        _t0 = _time.time()
        rows = native.mapping_cigars_native(
            mapping[: len(chunk)], reads[: len(chunk)],
            drafts[: len(chunk)], r_lens[: len(chunk)],
            d_lens[: len(chunk)],
        )
        if rows is not None:
            for k, i in enumerate(chunk):
                results[i] = rows[k]
        else:
            for k, i in enumerate(chunk):
                q, t = segments[i]
                results[i] = mapping_to_cigar(mapping[k], q, t)
        _prof("convert", _time.time() - _t0)
    return results


def _decode_runs_py(runs_row: np.ndarray, n: int, q_codes: np.ndarray,
                    t_codes: np.ndarray):
    """Pure-Python fallback for :func:`haslr_tpu.native.runs_cigars_native`
    on one row: reverse the traceback-ordered packed runs, normalize, and
    count exact matches (n_eq = -1 on overflow/malformed rows)."""
    if n < 0 or n > len(runs_row):
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), -1
    v = runs_row[:n][::-1].astype(np.int64)
    ops = (v & 3).astype(np.uint8)
    lens = (v >> 2) + 1
    qpos = np.cumsum(np.where(ops != ccigar.D, lens, 0))
    tpos = np.cumsum(np.where(ops != ccigar.I, lens, 0))
    if (
        (qpos[-1] if n else 0) != len(q_codes)
        or (tpos[-1] if n else 0) != len(t_codes)
    ):
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), -1
    n_eq = 0
    q0 = np.concatenate([[0], qpos[:-1]])
    t0 = np.concatenate([[0], tpos[:-1]])
    for k in np.nonzero(ops == ccigar.M)[0]:
        n_eq += int(
            np.sum(
                q_codes[q0[k] : qpos[k]] == t_codes[t0[k] : tpos[k]]
            )
        )
    return ccigar.normalize(ops, lens) + (n_eq,)


def chain_to_segments(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_anchor: np.ndarray,
    t_anchor: np.ndarray,
    k: int,
    exact_anchors: bool = True,
    coalesce: int = 256,
):
    """Decompose a chain into (literal_parts, nw_segments).

    Returns ``parts``: an ordered list of either ``("M", length, n_eq)``
    literal match runs (exact anchors / diagonal stretches) or
    ``("NW", seg_idx)`` placeholders, plus the list of (q_seg, t_seg)
    code-array pairs to align.  Shared by the single-read and batched
    extension paths.
    """
    parts = []
    segs = []
    cq, ct = int(q_anchor[0]), int(t_anchor[0])
    for q2, t2 in zip(q_anchor[1:], t_anchor[1:]):
        q2, t2 = int(q2), int(t2)
        dq, dt = q2 - cq, t2 - ct
        if dq <= 0 or dt <= 0:
            continue
        if dq == dt and exact_anchors:
            ne = int(np.sum(q_codes[cq : cq + dq] == t_codes[ct : ct + dq]))
            parts.append(("M", dq, ne))
            cq, ct = q2, t2
        elif exact_anchors:
            if dq < k or dt < k:
                continue
            parts.append(("M", k, k))
            parts.append(("NW", len(segs)))
            segs.append((q_codes[cq + k : q2], t_codes[ct + k : t2]))
            cq, ct = q2, t2
        else:
            if dq < coalesce and dt < coalesce and (q2, t2) != (
                int(q_anchor[-1]), int(t_anchor[-1])
            ):
                continue
            parts.append(("NW", len(segs)))
            segs.append((q_codes[cq:q2], t_codes[ct:t2]))
            cq, ct = q2, t2
    if exact_anchors:
        ne = int(np.sum(q_codes[cq : cq + k] == t_codes[ct : ct + k]))
        parts.append(("M", k, ne))
    else:
        qe = min(cq + k, len(q_codes))
        te = min(ct + k, len(t_codes))
        parts.append(("NW", len(segs)))
        segs.append((q_codes[cq:qe], t_codes[ct:te]))
    return parts, segs


def assemble_parts(parts, seg_results, seg_base=0):
    """Stitch literal parts + aligned segments into one normalized CIGAR.

    ``seg_base`` offsets the NW part indices into ``seg_results`` —
    callers pass the WHOLE result list plus the base instead of slicing
    it per record (``seg_results[base:]`` copies the list tail: O(n^2)
    over a mapping run)."""
    ops_list = []
    lens_list = []
    n_match = 0
    for part in parts:
        if part[0] == "M":
            ops_list.append(np.array([ccigar.M], np.uint8))
            lens_list.append(np.array([part[1]], np.int64))
            n_match += part[2]
        else:
            o, l, ne = seg_results[seg_base + part[1]]
            ops_list.append(o)
            lens_list.append(l)
            n_match += ne
    ops = np.concatenate(ops_list)
    lens = np.concatenate(lens_list)
    return ccigar.normalize(ops, lens) + (n_match,)


def chain_to_cigar(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_anchor: np.ndarray,
    t_anchor: np.ndarray,
    k: int,
    exact_anchors: bool = True,
):
    """CIGAR over [q_anchor[0], q_anchor[-1]+k) x [t_anchor[0], ...+k),
    aligning gap segments on host (single-read path; the batched pipeline
    in :mod:`haslr_tpu.aligner.map` sends segments through the device
    kernel instead).  Returns (ops, lens, n_match)."""
    parts, segs = chain_to_segments(
        q_codes, t_codes, q_anchor, t_anchor, k, exact_anchors
    )
    seg_results = [nw_cigar(q, t) for q, t in segs]
    return assemble_parts(parts, seg_results)
