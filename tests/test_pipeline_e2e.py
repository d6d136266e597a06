"""Grand end-to-end test: raw short + long reads through the CLI driver —
every stage is ours (k-mer counting, dBG contigs, nooverlap, subsampling,
minimizer alignment, backbone assembly, consensus, stitching)."""

import os

import numpy as np
import pytest

from haslr_tpu.core import io as cio
from haslr_tpu.core import seq as cseq
from haslr_tpu.testutil import simulate


def kmer_set(s, k=31):
    return {
        min(s[i : i + k], cseq.revcomp(s[i : i + k]))
        for i in range(len(s) - k + 1)
    }


def test_pipeline_from_raw_reads(tmp_path):
    rng = np.random.default_rng(11)
    # repeats fragment the SR assembly into contigs; the long-read backbone
    # must bridge them (a repeat-free genome compacts into ONE contig and
    # HASLR-like pipelines then have no edges to build — faithful behavior)
    genome = simulate.genome_with_repeats(
        rng, 30_000, n_families=2, copies_per_family=4, repeat_len=400
    )
    srs = simulate.make_short_reads(rng, genome, coverage=45.0)
    sr_path = str(tmp_path / "sr.fq")
    simulate.write_short_reads(sr_path, srs)
    lrs = simulate.make_reads(rng, genome, coverage=18.0, mean_len=8000,
                              error_rate=0.05)
    lr_path = str(tmp_path / "lr.fa")
    with open(lr_path, "w") as fp:
        for r in lrs:
            fp.write(f">sim{r.rid} original_name\n{r.seq}\n")

    from haslr_tpu.cli.haslr import main

    out = str(tmp_path / "out")
    rc = main([
        "-o", out, "-g", "30k", "-l", lr_path, "-x", "pacbio",
        "-s", sr_path, "--minia-kmer", "49", "--cov-lr", "25",
        "--platform", "cpu",
    ])
    assert rc == 0
    # artifacts with reference-compatible names
    assert os.path.isfile(f"{out}/lr25x.fasta")
    assert os.path.isfile(f"{out}/sr_k49_a3.contigs.fa")
    assert os.path.isfile(f"{out}/sr_k49_a3.contigs.nooverlap.fa")
    assert os.path.isfile(f"{out}/sr_k49_a3.contigs.nooverlap.250.fa")
    assert os.path.isfile(f"{out}/map_contigs_k49_a3_c250_lr25x.paf")
    asm_dir = f"{out}/asm_contigs_k49_a3_c250_lr25x_b500_s3_sim0.85"
    final = f"{asm_dir}/asm.final.fa"
    assert os.path.isfile(final)
    assert os.path.isfile(f"{asm_dir}/backbone.01.init.gfa")

    recs = list(cio.read_fastx(final))
    total = sum(len(r.seq) for r in recs)
    assert total > 0.9 * len(genome)
    ak = set()
    for r in recs:
        ak |= kmer_set(r.seq)
    gk = kmer_set(genome[1500:-1500])
    recall = len(gk & ak) / len(gk)
    assert recall > 0.97, f"interior kmer recall {recall:.4f}"

    # resume: re-running skips every stage (outputs exist)
    rc = main([
        "-o", out, "-g", "30k", "-l", lr_path, "-x", "pacbio",
        "-s", sr_path, "--minia-kmer", "49", "--cov-lr", "25",
        "--platform", "cpu",
    ])
    assert rc == 0


def test_pipeline_nanopore_grade_errors(tmp_path):
    """End-to-end at the HARD error regime: 11% homopolymer-biased long-
    read error (ONT-like) over a genome with 98%-identity diverged repeat
    families, nanopore preset.  The assembly must still reconstruct the
    genome: high interior 31-mer recall and NG50 in the
    backbone-bridging regime (far above the SR contig N50)."""
    rng = np.random.default_rng(23)
    # exact families fragment the SR assembly (so a real backbone
    # exists); diverged families layered on top stress the aligner
    G = 80_000
    genome = simulate.genome_with_repeats(
        rng, G, n_families=3, copies_per_family=5, repeat_len=400,
    )
    genome = simulate.genome_with_repeats(
        rng, G, n_families=2, copies_per_family=4, repeat_len=400,
        divergence=0.02, base=genome,
    )
    srs = simulate.make_short_reads(rng, genome, coverage=45.0)
    sr_path = str(tmp_path / "sr.fq")
    simulate.write_short_reads(sr_path, srs)
    lrs = simulate.make_reads(
        rng, genome, coverage=22.0, mean_len=9000, error_rate=0.11,
        homopolymer_bias=1.0,
    )
    lr_path = str(tmp_path / "lr.fa")
    with open(lr_path, "w") as fp:
        for r in lrs:
            fp.write(f">sim{r.rid}\n{r.seq}\n")

    from haslr_tpu.cli.haslr import main

    out = str(tmp_path / "out")
    rc = main([
        "-o", out, "-g", "80k", "-l", lr_path, "-x", "nanopore",
        "-s", sr_path, "--platform", "cpu",
    ])
    assert rc == 0
    import glob

    final = glob.glob(f"{out}/asm_*/asm.final.fa")[0]
    recs = list(cio.read_fastx(final))
    assert recs, "no contigs assembled"
    lens = sorted((len(r.seq) for r in recs), reverse=True)
    # NG50 over the known genome size
    half, acc, ng50 = len(genome) / 2, 0, 0
    for L in lens:
        acc += L
        if acc >= half:
            ng50 = L
            break
    gk = kmer_set(genome[1000:-1000])
    ak = set()
    for r in recs:
        ak |= kmer_set(r.seq)
    recall = len(gk & ak) / len(gk)
    # capability bars, not perfection: at 11% error a fraction of
    # alignments genuinely fails the reference's identity/MAPQ gates
    # (aln-sim 0.85, MAPQ 55 — the same filters the reference applies,
    # Longread.cpp:262-272), so some weak edges drop and coverage is
    # lost with them.  Measured 0.77 recall / 36.8 kb NG50 at this
    # config; the bars guard against regression with margin.
    assert recall >= 0.70, recall
    assert ng50 >= 20_000, (ng50, lens[:5])
