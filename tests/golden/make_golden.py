"""Regenerate the golden parity fixture.

Run from the repo root:

    JAX_PLATFORMS=cpu python tests/golden/make_golden.py

Produces ``tests/golden/input/`` (a small simulated contigs + long-reads +
PAF dataset, gzipped) and ``tests/golden/expected/`` (the byte-exact stage
artifacts the assembler must reproduce: ``compact_uniq.txt`` and every
``backbone.NN.*`` GFA/stat through the cleaning cascade — the same
diffable stage snapshots the reference emits, main.cpp:133-196).

The dataset is CONSTRUCTED so that every cleaning pass fires: 2-support
chimeras make a weak edge (Backbone_graph.cpp:348-375), reads joined to an
otherwise-unmapped terminal contig make a tip (Cleaning.cpp:59-96),
deletion reads skipping 1 / 2 / 5 consecutive contigs make a small bubble
(Cleaning.cpp:7-57), a simple bubble (Cleaning.cpp:98-184) and a super
bubble (Cleaning.cpp:565-648) respectively — so the fixture pins the
cleaning semantics byte-for-byte, not just the happy path.

The graph stages are deterministic host code, so these bytes are
platform-independent; ``tests/test_golden.py`` asserts equality on every
run.  Regenerate ONLY when a deliberate semantic change is made, and
inspect the diff of the expected artifacts when you do.
"""

import gzip
import os
import shutil
import sys
import tempfile

import jax

# the goldens are written by the CPU backend (no backend is initialized
# yet, so this update takes effect; see tests/conftest)
jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

GOLDEN_ARTIFACTS = [
    "compact_uniq.txt",
    "backbone.01.init.gfa",
    "backbone.01.init.stat",
    "backbone.02.weakEdge.gfa",
    "backbone.02.weakEdge.stat",
    "backbone.03.tip.gfa",
    "backbone.03.tip.stat",
    "backbone.04.simplebubble.gfa",
    "backbone.04.simplebubble.stat",
    "backbone.05.superbubble.gfa",
    "backbone.05.superbubble.stat",
    "backbone.06.smallbubble.gfa",
    "backbone.06.smallbubble.stat",
    "backbone.branching.log",
    # final sequence output (poa engine): locks coords + consensus +
    # stitching byte-for-byte, .ann included (provenance rows,
    # Assemble.cpp:688-747)
    "asm.final.fa",
    "asm.final.ann",
]

# the device (dense) engine's final output, pinned separately — its vote
# semantics differ from exact POA by design, but are equally
# deterministic (integer arithmetic only, CPU backend in tests)
GOLDEN_DEVICE_ARTIFACTS = ["asm.final.fa", "asm.final.ann"]


def _chimera(rng, rid, genome, spans, error_rate, contigs):
    """A read stitched from several genome spans (forward strand): the
    sequence is the concatenation of the mutated spans and the PAF records
    are each span's true records with query coordinates rebased."""
    from haslr_tpu.testutil import simulate

    recs = []
    seqs = []
    qoff = 0
    for a, b in spans:
        seq, ops, is_sub = simulate.mutate_with_trace(
            rng, genome[a:b], error_rate
        )
        r = simulate.SimRead(rid, a, b, 0, seq, ops, is_sub)
        for rec in simulate.true_paf_records(r, contigs):
            rec = dict(rec)
            rec["q_start"] += qoff
            rec["q_end"] += qoff
            recs.append(rec)
        qoff += len(seq)
        seqs.append(seq)
    full = "".join(seqs)
    for rec in recs:
        rec["q_len"] = len(full)
    recs.sort(key=lambda r: r["q_start"])
    return full, recs


def _fmt(rec):
    return (
        "{q_name}\t{q_len}\t{q_start}\t{q_end}\t{strand}\t"
        "{t_name}\t{t_len}\t{t_start}\t{t_end}\t{n_match}\t"
        "{n_block}\t{mapq}\ttp:A:P\tcg:Z:{cigar}\n".format(**rec)
    )


def make_dataset(out_dir):
    import numpy as np

    from haslr_tpu.testutil import simulate

    rng = np.random.default_rng(7)
    genome = simulate.random_genome(rng, 70_000)
    contigs = simulate.make_contigs(
        rng, genome, mean_len=1200, gap_len=120, rev_fraction=0.35
    )
    reads = simulate.make_reads(
        rng, genome, coverage=20.0, mean_len=6000, error_rate=0.08
    )

    order = sorted(contigs, key=lambda c: c.start)

    def gap_mid(i):
        """Midpoint of the gap AFTER order[i] (before order[i+1])."""
        return (order[i].end + order[i + 1].start) // 2

    def span_of(i0, i1):
        """A genome span covering order[i0..i1] and nothing else."""
        lo = gap_mid(i0 - 1) if i0 > 0 else 0
        hi = gap_mid(i1) if i1 + 1 < len(order) else len(genome)
        return lo, hi

    chim = []  # (sequence, records)
    rid = len(reads)
    err = 0.08

    def add(spans, n):
        nonlocal rid
        for _ in range(n):
            chim.append(_chimera(rng, rid, genome, spans, err, contigs))
            rid += 1

    # weak edge (support 2 < --edge-sup 3): order[2] -> order[10]
    add([span_of(2, 2), span_of(10, 10)], 2)
    # simple bubble: skip order[8]; shortcut edge order[7]-order[9] vs the
    # true 2-edge path (the branching node has exactly 2 out-edges)
    add([span_of(6, 7), span_of(9, 10)], 4)
    # super bubble: skip order[13..17]; the true path is 6 edges long —
    # beyond simple-bubble depth 4, caught by the topological sweep
    add([span_of(11, 12), span_of(18, 19)], 4)
    # small bubble: skip order[22]; give BOTH bubble endpoints a THIRD
    # edge on the bubble side (order[21]->order[30], order[33]->order[23])
    # so the exactly-2-edge simple-bubble pass skips them from either end
    # and the shortcut survives to the small-bubble pass
    add([span_of(20, 21), span_of(23, 24)], 4)
    add([span_of(21, 21), span_of(30, 30)], 5)
    add([span_of(33, 33), span_of(23, 23)], 5)
    # tip: order[-1] (genome-terminal) keeps NO true alignments (dropped
    # below); 4 chimeras from interior order[26] are its only edge
    tip_cid = order[len(order) - 1].cid
    add([span_of(26, 26), span_of(len(order) - 1, len(order) - 1)], 4)

    contig_path = f"{out_dir}/contigs.fa"
    with open(contig_path, "w") as fp:
        for c in contigs:
            fp.write(
                f">{c.cid} LN:i:{len(c.seq)} KC:i:{c.kc} km:f:{c.km:.3f}\n"
                f"{c.seq}\n"
            )
    lr_path = f"{out_dir}/lr.fasta"
    with open(lr_path, "w") as fp:
        for r in reads:
            fp.write(f">{r.rid}\n{r.seq}\n")
        for i, (seq, _) in enumerate(chim):
            fp.write(f">{len(reads) + i}\n{seq}\n")
    paf_path = f"{out_dir}/map.paf"
    with open(paf_path, "w") as fp:
        for r in reads:
            for rec in simulate.true_paf_records(r, contigs):
                if rec["t_name"] == str(tip_cid):
                    continue  # the tip contig is anchored by chimeras only
                fp.write(_fmt(rec))
        for _, recs in chim:
            for rec in recs:
                fp.write(_fmt(rec))
    return contig_path, lr_path, paf_path


def main():
    from haslr_tpu.assemble.pipeline import run_assembler
    from haslr_tpu.config import AssembleConfig

    in_dir = os.path.join(HERE, "input")
    exp_dir = os.path.join(HERE, "expected")
    shutil.rmtree(in_dir, ignore_errors=True)
    shutil.rmtree(exp_dir, ignore_errors=True)
    os.makedirs(in_dir)
    os.makedirs(exp_dir)

    with tempfile.TemporaryDirectory() as tmp:
        contig_path, lr_path, paf_path = make_dataset(tmp)
        for src, dst in [
            (contig_path, "contigs.fa.gz"),
            (lr_path, "lr.fa.gz"),
            (paf_path, "map.paf.gz"),
        ]:
            with open(src, "rb") as fi, gzip.GzipFile(
                os.path.join(in_dir, dst), "wb", mtime=0
            ) as fo:
                fo.write(fi.read())

        cfg = AssembleConfig(consensus_engine="poa")
        run_assembler(
            contig_path, lr_path, paf_path, f"{tmp}/asm", cfg=cfg,
            log=None,
        )
        for name in GOLDEN_ARTIFACTS:
            shutil.copyfile(
                f"{tmp}/asm/{name}", os.path.join(exp_dir, name)
            )
        cfg_dev = AssembleConfig(consensus_engine="device")
        run_assembler(
            contig_path, lr_path, paf_path, f"{tmp}/asm_device",
            cfg=cfg_dev, log=None,
        )
        for name in GOLDEN_DEVICE_ARTIFACTS:
            shutil.copyfile(
                f"{tmp}/asm_device/{name}",
                os.path.join(exp_dir, f"device.{name}"),
            )
    print(f"golden fixture written: {in_dir} + {exp_dir}")


if __name__ == "__main__":
    main()
