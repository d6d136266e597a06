"""Assembler binary-index resume + standalone haslr_assemble CLI tests."""

import os

import numpy as np
import pytest

from haslr_tpu.assemble import index_io
from haslr_tpu.assemble.contig_store import ContigStore
from haslr_tpu.assemble.longread_store import LongreadStore, load_alignments
from haslr_tpu.config import AssembleConfig
from haslr_tpu.core import io as cio
from haslr_tpu.testutil import simulate


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    out = tmp_path_factory.mktemp("resume")
    genome, contigs, reads, paths = simulate.simulate(
        str(out), genome_len=20_000, seed=5, coverage=12.0, error_rate=0.05
    )
    return genome, paths, str(out)


def test_contig_index_roundtrip(sim, tmp_path):
    _, (contig_path, _, _), _ = sim
    store = ContigStore.load_fasta(contig_path)
    idx = str(tmp_path / "index.contig.npz")
    index_io.write_contig_index(idx, store)
    back = index_io.read_contig_index(idx)
    assert len(back) == len(store)
    assert back.kmer_count == store.kmer_count
    assert back.mean_kmer == store.mean_kmer
    for i in range(len(store)):
        assert back.get_str(i) == store.get_str(i)


def test_longread_index_roundtrip(sim, tmp_path):
    _, (contig_path, lr_path, paf_path), _ = sim
    cfg = AssembleConfig()
    contigs = ContigStore.load_fasta(contig_path)
    uf = contigs.calc_uniq_freq()
    lrs = LongreadStore.load_fasta(lr_path)
    n = load_alignments(paf_path, contigs, lrs, uf, cfg)
    idx = str(tmp_path / "index.longread.npz")
    index_io.write_longread_index(idx, lrs)
    back, n2 = index_io.read_longread_index(idx)
    assert n2 == n
    assert len(back) == len(lrs)
    for rid in range(len(lrs)):
        assert back.seqs.get_str(rid) == lrs.seqs.get_str(rid)
        assert len(back.alignments[rid]) == len(lrs.alignments[rid])
        for a, b in zip(lrs.alignments[rid], back.alignments[rid]):
            assert (a.q_start, a.q_end, a.t_id, a.t_start, a.t_end,
                    a.is_rev, a.n_match) == (
                b.q_start, b.q_end, b.t_id, b.t_start, b.t_end,
                b.is_rev, b.n_match)
            np.testing.assert_array_equal(a.ops, b.ops)
            np.testing.assert_array_equal(a.lens, b.lens)


def test_haslr_assemble_cli_and_resume(sim, tmp_path):
    _, (contig_path, lr_path, paf_path), _ = sim
    from haslr_tpu.cli.haslr_assemble import main

    out = str(tmp_path / "asmcli")
    rc = main([
        "-c", contig_path, "-l", lr_path, "-m", paf_path, "-d", out,
        "--consensus-engine", "poa", "--platform", "cpu",
    ])
    assert rc == 0
    assert os.path.isfile(f"{out}/asm.final.fa")
    assert os.path.isfile(f"{out}/index.contig.npz")
    assert os.path.isfile(f"{out}/index.longread.npz")
    first = open(f"{out}/asm.final.fa").read()
    # delete inputs: the index resume path must reproduce the assembly
    rc = main([
        "-c", "/nonexistent.fa", "-l", "/nonexistent2.fa",
        "-m", "/nonexistent3.paf", "-d", out, "--consensus-engine", "poa",
        "--platform", "cpu",
    ])
    assert rc == 0
    assert open(f"{out}/asm.final.fa").read() == first


def test_resolve_4way_paths_merges():
    """Two chains through a shared 2-in/2-out node merge when supports
    pair decisively."""
    from collections import deque

    from haslr_tpu.assemble import backbone as bb
    from haslr_tpu.assemble.stitch import resolve_4way_paths

    g = [bb.BBGNode(contig_id=i) for i in range(5)]

    def link(n1, r1, n2, r2, lr_ids):
        e1 = g[n1].edges[r1].get_or_create(bb.edge_key(n2, r2))
        e2 = g[n2].edges[1 - r2].get_or_create(bb.edge_key(n1, 1 - r1))
        for lid in lr_ids:
            e1.edge_supp.append(bb.EdgeSupp(lid, 0, 0, 1))
            e2.edge_supp.append(bb.EdgeSupp(lid, 1, 1, 0))

    # center path [2]; in: 0->2 (reads 0-9), 1->2 (10-19);
    # out: 2->3 (0-9), 2->4 (10-19): pairing 0-3 and 1-4
    link(0, 0, 2, 0, range(0, 10))
    link(1, 0, 2, 0, range(10, 20))
    link(2, 0, 3, 0, range(0, 10))
    link(2, 0, 4, 0, range(10, 20))
    paths = [
        deque([(2, 0)]),
        deque([(0, 0)]),
        deque([(1, 0)]),
        deque([(3, 0)]),
        deque([(4, 0)]),
    ]
    deleted = resolve_4way_paths(g, paths)
    survivors = [list(p) for i, p in enumerate(paths) if not deleted[i]]
    flat = sorted(tuple(x) for p in survivors for x in p)
    # both merged paths exist, middle appears in both merges
    assert sum(deleted) == 3
    assert len(survivors) == 2
    for p in survivors:
        assert (2, 0) in p or (2, 1) in p
