"""Read mapping: seed → chain → extend → PAF.

Drop-in stage for the reference's minimap2 invocation
(``bin/haslr.py:81-110``).  Per read: extract minimizers, look them up in
the replicated contig index, chain per (contig, relative strand), accept
chains greedily by score with <50% query overlap (the behavior
``--secondary=no`` exposes: one best alignment per read region, but a read
spanning several contigs yields several records), extend each accepted
chain to a full CIGAR, and emit PAF lines with ``cg:Z`` tags.

MAPQ follows minimap2's shape — ``60 * (1 - f2/f1) * min(1, n/10)`` where
f2 is the best query-overlapping competitor chain — giving 60 for unique
mappings and dropping sharply for repeats (HASLR keeps only MAPQ >= 55,
reference Longread.cpp:268).
"""

from __future__ import annotations


import numpy as np

from haslr_tpu.aligner import minimizer as mz
from haslr_tpu.aligner.chain import chain_anchors
from haslr_tpu.aligner.extend import chain_to_cigar
from haslr_tpu.aligner.index import MinimizerIndex
from haslr_tpu.core import cigar as ccigar
from haslr_tpu.core import io as cio
from haslr_tpu.core import seq as cseq

# wall-clock of the last map_reads call by phase (seed_chain / extend /
# emit); PROF.clear() to reset — mirrors assemble_sr.PROF
PROF: dict[str, float] = {}

# read type -> (k, w, homopolymer-compression), mirroring bin/haslr.py:90-95
PRESETS = {
    "corrected": (19, 10, False),
    "pacbio": (17, 10, True),
    "nanopore": (15, 10, False),
}


def collect_anchors(idx: MinimizerIndex, codes: np.ndarray):
    """All (contig_id, rel_strand, t_pos, q_pos) anchors for one read,
    grouped by (contig, relative strand).

    Returns ``(cids, rels, group_off, t, q)``: per-group contig id and
    strand plus (n_groups + 1) offsets into the flat anchor arrays,
    which are sorted by (cid, rel, t, q) — so each group's slice is
    sorted by (t, q), the chaining DP's input contract.  ``q_pos`` is in
    the frame of the read orientation that matches the target forward
    strand (for rel_strand==1 a position on the reverse-complemented
    read); conversion back to original read coordinates happens at PAF
    emission.
    """
    rlen = len(codes)
    z = np.zeros(0, np.int64)
    h, qp, qe, qs = mz.minimizers(codes, idx.k, idx.w, idx.hpc)
    lo, hi = idx.lookup(h)
    occ = hi - lo
    keep = (occ > 0) & (occ <= idx.max_occ)
    if not keep.any():
        return z, z, np.zeros(1, np.int64), z, z
    l, c = lo[keep], (hi - lo)[keep]
    total = int(c.sum())
    # enumerate all index entries of all kept seeds in one shot
    starts = np.concatenate([[0], np.cumsum(c)[:-1]])
    flat = np.repeat(l, c) + (np.arange(total) - np.repeat(starts, c))
    cid = idx.contig_ids[flat]
    rel = np.repeat(qs[keep], c) ^ idx.strands[flat]
    t = idx.positions[flat]
    # on the revcomp read the k-mer starts at rlen - end; under HPC the
    # span exceeds k, so the true end matters
    q = np.where(
        rel == 0, np.repeat(qp[keep], c), rlen - np.repeat(qe[keep], c)
    )
    # group by (contig, rel strand)
    order = np.lexsort((q, t, rel, cid))
    cid, rel, t, q = cid[order], rel[order], t[order], q[order]
    boundary = np.concatenate(
        [[True], (cid[1:] != cid[:-1]) | (rel[1:] != rel[:-1])]
    )
    g0 = np.nonzero(boundary)[0]
    group_off = np.concatenate([g0, [total]]).astype(np.int64)
    return (cid[g0].astype(np.int64), rel[g0].astype(np.int64),
            group_off, t.astype(np.int64), q.astype(np.int64))


def accept_chains(idx, codes, min_chain_score=40.0, min_anchors=3):
    """Chain anchors in every (contig, strand) group and greedily accept
    chains with <50% query overlap, tracking the best comparable
    competitor per accepted chain for MAPQ.  Returns rows
    ``[score, f2, cid, rel, t_arr, q_arr, (qs, qe)]``.

    All of a read's groups chain in ONE native call
    (``native.chain_anchors_batch_native``) — the per-group ctypes
    crossing was ~44% of the whole seed+chain phase at the 50 Mb tier
    (6.8M tiny calls)."""
    from haslr_tpu import native

    rlen = len(codes)
    cids, rels, group_off, t_all, q_all = collect_anchors(idx, codes)
    all_chains = []  # (score, cid, rel, t_arr, q_arr)
    batch = (
        native.chain_anchors_batch_native(
            t_all, q_all, group_off, idx.k, 50, 5000, min_chain_score,
            min_anchors,
        )
        if len(cids)
        else (np.zeros(0), np.zeros(0, np.int64), np.zeros(1, np.uint64),
              np.zeros(0, np.int64))
    )
    if batch is not None:
        scores, gids, offs, idxs = batch
        for ci in range(len(scores)):
            g = int(gids[ci])
            base = group_off[g]
            sel = base + idxs[offs[ci] : offs[ci + 1]]
            all_chains.append((
                float(scores[ci]), int(cids[g]), int(rels[g]),
                t_all[sel], q_all[sel],
            ))
    else:
        for g in range(len(cids)):
            sl = slice(group_off[g], group_off[g + 1])
            chains = chain_anchors(
                t_all[sl], q_all[sl], idx.k,
                min_score=min_chain_score, min_anchors=min_anchors,
            )
            base = group_off[g]
            for score, sel in chains:
                all_chains.append((
                    score, int(cids[g]), int(rels[g]),
                    t_all[base + sel], q_all[base + sel],
                ))
    all_chains.sort(key=lambda c: -c[0])
    accepted = []
    for score, cid, rel, t_arr, q_arr in all_chains:
        qs, qe = int(q_arr.min()), int(q_arr.max()) + idx.k
        if rel == 1:
            qs, qe = rlen - qe, rlen - qs
        overlapped = None
        for acc in accepted:
            a_qs, a_qe = acc[6]
            ov = min(qe, a_qe) - max(qs, a_qs)
            if ov > 0.5 * min(qe - qs, a_qe - a_qs):
                overlapped = acc
                break
        if overlapped is None:
            accepted.append([score, 0.0, cid, rel, t_arr, q_arr, (qs, qe)])
        elif score >= 0.25 * overlapped[0]:
            # sub-chain crumbs of the winner score far below it and say
            # nothing about mapping ambiguity; only comparable competitors
            # (true alternative placements) lower MAPQ
            overlapped[1] = max(overlapped[1], score)
    return accepted


def _emit_record(name, rlen, rel, cid, contig_names, t_codes, q_arr, t_arr,
                 ops, lens, n_match, score, f2):
    q_beg = int(q_arr[0])
    q_end = q_beg + ccigar.query_len(ops, lens)
    t_beg = int(t_arr[0])
    t_end = t_beg + ccigar.target_len(ops, lens)
    n_block = ccigar.n_columns(ops, lens)
    n = len(t_arr)
    mapq = int(
        min(60, 60.0 * (1.0 - f2 / max(score, 1e-9)) * min(1.0, n / 10))
    )
    if rel == 0:
        qs_out, qe_out = q_beg, q_end
    else:
        qs_out, qe_out = rlen - q_end, rlen - q_beg
    return cio.PafRecord(
        q_name=name,
        q_len=rlen,
        q_start=qs_out,
        q_end=qe_out,
        strand="-" if rel else "+",
        t_name=contig_names[cid],
        t_len=len(t_codes),
        t_start=t_beg,
        t_end=t_end,
        n_match=n_match,
        n_block=n_block,
        mapq=mapq,
        tags={"tp": "P", "cg": ccigar.to_string(ops, lens)},
    )


def map_read(
    idx: MinimizerIndex,
    codes: np.ndarray,
    name: str,
    contig_codes: list,
    contig_names: list,
    min_chain_score: float = 40.0,
    min_anchors: int = 3,
) -> list[cio.PafRecord]:
    rlen = len(codes)
    if rlen < idx.k:
        return []
    rc = cseq.revcomp_codes(codes)
    accepted = accept_chains(idx, codes, min_chain_score, min_anchors)
    # extend + emit (host path; map_reads batches segments on device)
    records = []
    for score, f2, cid, rel, t_arr, q_arr, (qs0, qe0) in accepted:
        q_codes = codes if rel == 0 else rc
        t_codes = contig_codes[cid]
        order = np.argsort(t_arr, kind="stable")
        t_arr, q_arr = t_arr[order], q_arr[order]
        ops, lens, n_match = chain_to_cigar(
            q_codes, t_codes, q_arr, t_arr, idx.k,
            exact_anchors=not idx.hpc,
        )
        records.append(
            _emit_record(name, rlen, rel, cid, contig_names, t_codes,
                         q_arr, t_arr, ops, lens, n_match, score, f2)
        )
    records.sort(key=lambda r: (r.q_start, r.q_end))
    return records


def _seed_chain_segments(idx, contig_codes, reads, min_chain_score):
    """Phase 1 for a stream of reads: seed + chain + decompose chains into
    literal parts and NW segments.  Pure host work (numpy + the native
    chaining DP) — no device involvement, so it shards across plain
    worker processes while the device stays with the caller.

    ``reads`` yields ``(ri, name, codes)`` with ``ri`` the global read
    index (used to restore file order at emission).  Returns ``(pending,
    segments)``; pending rows are ``(ri, name, rlen, rel, cid, q_arr,
    t_arr, parts, seg_base, score, f2)`` with NW part indices relative to
    ``seg_base``.
    """
    from haslr_tpu.aligner.extend import chain_to_segments

    pending = []
    segments = []
    for ri, name, codes in reads:
        rlen = len(codes)
        if rlen < idx.k:
            continue
        rc = cseq.revcomp_codes(codes)
        for score, f2, cid, rel, t_arr, q_arr, _span in accept_chains(
            idx, codes, min_chain_score
        ):
            q_codes = codes if rel == 0 else rc
            t_codes = contig_codes[cid]
            order = np.argsort(t_arr, kind="stable")
            t_arr, q_arr = t_arr[order], q_arr[order]
            parts, segs = chain_to_segments(
                q_codes, t_codes, q_arr, t_arr, idx.k,
                exact_anchors=not idx.hpc,
            )
            pending.append(
                (ri, name, rlen, rel, cid, q_arr, t_arr, parts,
                 len(segments), score, f2)
            )
            segments.extend(segs)
    return pending, segments


def _emit_all(pending, seg_results, contig_names, contig_codes, out_paf):
    """Phase 3: assemble CIGARs, restore read-file order, write PAF.

    Field math mirrors :func:`_emit_record`; the formatting + file write
    happen in ONE native call (``native/paf.cpp`` — byte-identical to
    ``PafRecord.to_line``), with the Python writer as fallback.  A
    stable sort on (read index, q_start, q_end) reproduces the
    per-read ordering exactly."""
    from haslr_tpu import native
    from haslr_tpu.aligner.extend import assemble_parts

    rows = []
    for (ri, name, rlen, rel, cid, q_arr, t_arr, parts, seg_base, score,
         f2) in pending:
        ops, lens, n_match = assemble_parts(parts, seg_results, seg_base)
        q_beg = int(q_arr[0])
        q_end = q_beg + ccigar.query_len(ops, lens)
        t_beg = int(t_arr[0])
        t_end = t_beg + ccigar.target_len(ops, lens)
        n_block = ccigar.n_columns(ops, lens)
        mapq = int(
            min(60, 60.0 * (1.0 - f2 / max(score, 1e-9))
                * min(1.0, len(t_arr) / 10))
        )
        if rel == 0:
            qs_out, qe_out = q_beg, q_end
        else:
            qs_out, qe_out = rlen - q_end, rlen - q_beg
        rows.append((
            ri, qs_out, qe_out, name,
            (rlen, qs_out, qe_out, rel, cid, len(contig_codes[cid]),
             t_beg, t_end, n_match, n_block, mapq),
            ops, lens,
        ))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    n = len(rows)
    if n:
        fields = np.array([r[4] for r in rows], np.int64)
        names = [r[3] for r in rows]
        ops_blob = np.concatenate([r[5] for r in rows])
        lens_blob = np.concatenate([r[6] for r in rows])
        cig_off = np.zeros(n + 1, np.uint64)
        np.cumsum([len(r[5]) for r in rows], out=cig_off[1:])
        rc = native.paf_write_native(
            out_paf, names, contig_names, fields, ops_blob, lens_blob,
            cig_off,
        )
        if rc is not None:
            return rc
    with open(out_paf, "w") as fp:
        for ri, qs_out, qe_out, name, fld, ops, lens in rows:
            (rlen, _qs, _qe, rel, cid, t_len, t_beg, t_end, n_match,
             n_block, mapq) = fld
            pr = cio.PafRecord(
                q_name=name, q_len=rlen, q_start=qs_out, q_end=qe_out,
                strand="-" if rel else "+", t_name=contig_names[cid],
                t_len=t_len, t_start=t_beg, t_end=t_end, n_match=n_match,
                n_block=n_block, mapq=mapq,
                tags={"tp": "P", "cg": ccigar.to_string(ops, lens)},
            )
            fp.write(pr.to_line() + "\n")
    return n


def _load_contigs(contig_fasta):
    contig_names = []
    contig_codes = []
    for rec in cio.read_fastx(contig_fasta):
        contig_names.append(rec.name)
        contig_codes.append(cseq.encode(rec.seq))
    return contig_names, contig_codes


def map_reads(
    contig_fasta: str,
    reads_fasta: str,
    out_paf: str,
    read_type: str = "pacbio",
    min_chain_score: float = 40.0,
    threads: int = 1,
    host_shard: tuple[int, int] | None = None,
    mesh=None,
) -> int:
    """Map all reads; writes PAF; returns the record count.

    Equivalent of ``minimap2 -t T --secondary=no -c {preset} contigs lr``.
    Three phases: (1) seed + chain, host-only, sharded across ``threads``
    worker processes (round-robin over reads, index replicated — the same
    structure that shards reads across hosts, SURVEY.md
    §2.3); (2) ONE batched device alignment over every NW segment of every
    read, in this process, so the accelerator serves the whole read
    stream; (3) CIGAR assembly + PAF emission in read-file order.

    ``host_shard=(i, n)``: multi-host data-parallel streaming — this
    process maps only reads with ``read_index % n == i`` (the minimizer
    index is replicated, reads stream host-local).  Each host writes its
    own PAF shard; the assembler merges them via ``mapping_fofn``.  Use
    ``haslr_tpu.dist.host_shard()`` under ``jax.distributed``.
    """
    k, w, hpc = PRESETS[read_type]
    contig_names, contig_codes = _load_contigs(contig_fasta)
    sh_i, sh_n = host_shard if host_shard is not None else (0, 1)

    import time as _time

    PROF.clear()
    _t0 = _time.time()
    if threads > 1:
        # the worker processes each build their own index replica; the
        # main process never seeds, so building one here is pure waste
        pending, segments = _seed_chain_shards(
            contig_fasta, reads_fasta, read_type, min_chain_score, threads,
            host_shard,
        )
    else:
        idx = MinimizerIndex.build(contig_codes, k, w, hpc)

        def reads():
            for ri, rec in enumerate(cio.read_fastx(reads_fasta)):
                if ri % sh_n == sh_i:
                    yield ri, rec.name, cseq.encode(rec.seq)

        pending, segments = _seed_chain_segments(
            idx, contig_codes, reads(), min_chain_score
        )
    PROF["seed_chain"] = _time.time() - _t0
    PROF["n_segments"] = float(len(segments))

    from haslr_tpu.aligner.extend import batch_align_segments

    _t0 = _time.time()
    seg_results = batch_align_segments(segments, mesh=mesh)
    PROF["extend"] = _time.time() - _t0
    from haslr_tpu.aligner import extend as _ext

    PROF.update({f"extend.{k2}": v for k2, v in _ext.PROF.items()})
    _t0 = _time.time()
    n = _emit_all(
        pending, seg_results, contig_names, contig_codes, out_paf
    )
    PROF["emit"] = _time.time() - _t0
    return n


def _shard_worker(args):
    (contig_fasta, reads_fasta, read_type, min_chain_score, shard_idx,
     n_shards, host_shard) = args
    # phase 1 only: pure host work, no jax import, no device claim
    k, w, hpc = PRESETS[read_type]
    _, contig_codes = _load_contigs(contig_fasta)
    idx = MinimizerIndex.build(contig_codes, k, w, hpc)
    sh_i, sh_n = host_shard if host_shard is not None else (0, 1)

    def reads():
        for ri, rec in enumerate(cio.read_fastx(reads_fasta)):
            if ri % sh_n == sh_i and (ri // sh_n) % n_shards == shard_idx:
                yield ri, rec.name, cseq.encode(rec.seq)

    return _seed_chain_segments(idx, contig_codes, reads(), min_chain_score)


def _seed_chain_shards(
    contig_fasta, reads_fasta, read_type, min_chain_score, threads,
    host_shard=None,
):
    """Run phase 1 across worker processes; returns merged (pending,
    segments) with segment bases rebased onto the concatenated list."""
    import multiprocessing as mp

    args = [
        (contig_fasta, reads_fasta, read_type, min_chain_score, i, threads,
         host_shard)
        for i in range(threads)
    ]
    ctx = mp.get_context("spawn")
    with ctx.Pool(threads) as pool:
        shards = pool.map(_shard_worker, args)
    pending = []
    segments = []
    for sh_pending, sh_segments in shards:
        base = len(segments)
        for row in sh_pending:
            pending.append(row[:8] + (row[8] + base,) + row[9:])
        segments.extend(sh_segments)
    return pending, segments
