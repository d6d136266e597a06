"""End-to-end test of the core assembler on synthetic ground-truth data.

The reference has no test suite; its integration test is the E. coli quick
start (SURVEY.md §4).  Here we simulate a genome, short-read contigs with
gaps, noisy long reads and an exact PAF, run the full assembler pipeline,
and require that the output reconstructs the genome: few contigs, ~genome
length, and nearly all genome k-mers present.
"""

import numpy as np
import pytest

from haslr_tpu.assemble.pipeline import run_assembler
from haslr_tpu.config import AssembleConfig
from haslr_tpu.core import io as cio
from haslr_tpu.core import seq as cseq
from haslr_tpu.testutil import simulate


def kmer_set(s: str, k: int = 31):
    out = set()
    for i in range(len(s) - k + 1):
        km = s[i : i + k]
        out.add(min(km, cseq.revcomp(km)))
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    genome, contigs, reads, paths = simulate.simulate(
        str(out), genome_len=40_000, seed=1, coverage=18.0, error_rate=0.05
    )
    return genome, contigs, reads, paths, str(out)


def test_assembler_reconstructs_genome(dataset):
    genome, contigs, reads, (contig_path, lr_path, paf_path), out = dataset
    cfg = AssembleConfig(consensus_engine="poa")
    stats = run_assembler(
        contig_path, lr_path, paf_path, out + "/asm", cfg=cfg, log=None
    )
    recs = list(cio.read_fastx(stats["assembly"]))
    assert len(recs) >= 1
    total = sum(len(r.seq) for r in recs)
    # assembled length close to genome length
    assert total > 0.95 * len(genome)
    assert total < 1.10 * len(genome)
    # the genome should come back in very few pieces
    assert len(recs) <= 5
    # genome k-mer recall: consensus over gaps must reconstruct the sequence.
    # Genome ends lie beyond the outermost anchors (the reference drops them
    # too: isolated nodes are not emitted, and coverage at the ends falls
    # under --edge-sup), so the strict bar applies to the interior; SPOA-
    # semantics consensus admits ~1 bp of seam noise per junction, bounded
    # by the 0.985 interior bar.
    ak = set()
    for r in recs:
        ak |= kmer_set(r.seq)
    gk_all = kmer_set(genome)
    recall_all = len(gk_all & ak) / len(gk_all)
    assert recall_all > 0.92, f"total kmer recall {recall_all:.4f}"
    gk_mid = kmer_set(genome[2000:-2000])
    recall_mid = len(gk_mid & ak) / len(gk_mid)
    assert recall_mid > 0.985, f"interior kmer recall {recall_mid:.4f}"
    # stage artifacts exist
    import os

    for f in [
        "compact_uniq.txt",
        "backbone.01.init.gfa",
        "backbone.02.weakEdge.stat",
        "backbone.03.tip.gfa",
        "backbone.04.simplebubble.stat",
        "backbone.05.superbubble.gfa",
        "backbone.06.smallbubble.stat",
        "backbone.branching.log",
        "asm.final.ann",
    ]:
        assert os.path.isfile(out + "/asm/" + f), f


def test_assembler_device_engine(dataset):
    """The batched device consensus engine must reach at least POA quality."""
    genome, contigs, reads, (contig_path, lr_path, paf_path), out = dataset
    cfg = AssembleConfig(consensus_engine="device")
    stats = run_assembler(
        contig_path, lr_path, paf_path, out + "/asm_device", cfg=cfg, log=None
    )
    recs = list(cio.read_fastx(stats["assembly"]))
    total = sum(len(r.seq) for r in recs)
    assert total > 0.9 * len(genome)
    ak = set()
    for r in recs:
        ak |= kmer_set(r.seq)
    gk_mid = kmer_set(genome[2000:-2000])
    recall_mid = len(gk_mid & ak) / len(gk_mid)
    assert recall_mid > 0.985, f"interior kmer recall {recall_mid:.4f}"


def test_uniq_freq_estimate(dataset):
    genome, contigs, reads, (contig_path, _, _), out = dataset
    from haslr_tpu.assemble.contig_store import ContigStore

    store = ContigStore.load_fasta(contig_path)
    uf = store.calc_uniq_freq()
    # contigs were simulated with km ~ 30 * U(0.85, 1.15)
    assert 25 < uf < 36


def test_assembler_resolve_repeats_mode(dataset):
    """Opt-in repeat bridging (wired Align_LR2path capability) runs end-
    to-end and writes its log without degrading the assembly."""
    genome, contigs, reads, (contig_path, lr_path, paf_path), out = dataset
    cfg = AssembleConfig(consensus_engine="poa", resolve_repeats=True)
    stats = run_assembler(
        contig_path, lr_path, paf_path, out + "/asm_rep", cfg=cfg, log=None
    )
    import os

    assert os.path.isfile(out + "/asm_rep/log_repeat.txt")
    recs = list(cio.read_fastx(stats["assembly"]))
    total = sum(len(r.seq) for r in recs)
    assert total > 0.9 * len(genome)
