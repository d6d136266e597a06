"""Per-edge consensus: turn each edge's supporting long-read subsequences
into one consensus sequence.

Replaces reference ``asm_calc_single_cns_seq`` + MT queue
(``Assemble.cpp:479-605``).  Engine selection:

- ``"poa"``  — exact partial-order alignment per edge on host
  (:mod:`haslr_tpu.assemble.poa`), the SPOA-semantics reference engine.
- ``"device"`` — batched consensus on the accelerator: windows are
  length-bucketed and padded, all supporting reads of all windows aligned
  to their drafts by the batched banded-NW DP, consensus by weighted
  pileup vote (:mod:`haslr_tpu.kernels.consensus`).
"""

from __future__ import annotations

from haslr_tpu.assemble import backbone as bb
from haslr_tpu.config import AssembleConfig
from haslr_tpu.core import seq as cseq


def _edge_window_seqs(edge: bb.BBGEdge, lrs) -> list[str]:
    """Extract the supporting subsequences of one edge, replicating the
    reference's substring semantics (Assemble.cpp:503-543): positions are
    inclusive on the chosen strand; ``spos == epos + 1`` yields an empty
    string, and ``spos > epos + 1`` — an unsigned-underflow artifact in the
    C++ — yields the whole suffix from ``spos``."""
    out = []
    for s in edge.cns_supp:
        rseq = lrs.get_str(s.lr_id)
        if s.lr_strand:
            rseq = cseq.revcomp(rseq)
        if s.epos + 1 < s.spos:
            out.append(rseq[s.spos:])
        else:
            out.append(rseq[s.spos : s.epos + 1])
    return out


def calc_consensus(
    graph, lrs, cfg: AssembleConfig | None = None, log=None, mesh=None,
    log_path: str | None = None,
) -> int:
    """Consensus for every unique edge; flags edges 12 like the reference
    work queue.  Returns the number of edges processed.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis for the
    ``"device"`` engine — supporting reads shard data-parallel across the
    mesh and per-window vote tables psum-merge (the multi-chip
    replacement for the reference's pthread edge queue,
    Assemble.cpp:436-477,562-605); output is bit-identical to the
    single-device run.

    ``log_path``: when given, a per-edge record log in the reference's
    ``log_consensus.txt`` format (main.cpp:207, Assemble.cpp:501-558):
    the shared region, each supporting subsequence, and the consensus."""
    cfg = cfg or AssembleConfig()
    edges = []
    for n1, r1, n2, r2, edge, twin in bb.unique_edges(graph):
        if edge.flag == 12:
            continue
        edge.flag = 12
        twin.flag = 12
        edges.append((edge, twin))

    if cfg.consensus_engine == "device":
        from haslr_tpu.kernels.consensus import batched_consensus

        windows = [_edge_window_seqs(edge, lrs) for edge, _ in edges]

        def _warn(msg):
            import sys

            print(f"[WARNING] {msg}", file=sys.stderr)
            if log is not None:
                print(f"[WARNING] {msg}", file=log)

        results = batched_consensus(
            windows,
            match=cfg.poa_match,
            mismatch=cfg.poa_mismatch,
            gap=cfg.poa_gap,
            warn=_warn,
            mesh=mesh,
        )
        for (edge, twin), cns in zip(edges, results):
            edge.cns_seq = cns
            twin.cns_seq = cseq.revcomp(cns)
    else:
        windows = [_edge_window_seqs(edge, lrs) for edge, _ in edges]
        results = _host_poa_windows(
            windows, cfg.poa_match, cfg.poa_mismatch, cfg.poa_gap
        )
        for (edge, twin), cns in zip(edges, results):
            edge.cns_seq = cns
            twin.cns_seq = cseq.revcomp(cns)
    if log_path is not None:
        with open(log_path, "w") as fp:
            for edge, _twin in edges:
                fp.write(
                    f"[shared_region] head_end:{edge.head_end}\t"
                    f"tail_beg:{edge.tail_beg}\n"
                )
                for s, sub in zip(
                    edge.cns_supp, _edge_window_seqs(edge, lrs)
                ):
                    fp.write(
                        f">{s.lr_id} {'-' if s.lr_strand else '+'} "
                        f"{s.spos} {s.epos} {s.epos - s.spos + 1}\n"
                        f"{sub}\n"
                    )
                fp.write(f">CONSENSUS\n{edge.cns_seq}\n")
    return len(edges)


def _host_poa_windows(windows, match, mismatch, gap):
    """Exact POA per window on host: the native C++ engine (the SPOA-
    grade batch engine, haslr_tpu/native/poa.cpp) when available, else
    the Python reference engine — both bit-identical."""
    from haslr_tpu import native

    code_wins = [
        [cseq.encode(s) for s in seqs if len(s) > 0] for seqs in windows
    ]
    out = native.poa_consensus_native(code_wins, match, mismatch, gap)
    if out is not None:
        return [cseq.decode(c) for c in out]
    from haslr_tpu.assemble.poa import poa_consensus

    return [
        poa_consensus(seqs, match, mismatch, gap) for seqs in windows
    ]
