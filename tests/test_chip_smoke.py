"""chip_smoke.py's pure helpers at tiny size: NG50, interior k-mer recall,
the golden byte comparison, and the phase-(b) pair generator."""

import os

import numpy as np

from haslr_tpu.testutil import evaluate


def test_ng50():
    assert evaluate.ng50([10, 50, 30, 10], 100) == 50
    assert evaluate.ng50([20, 20, 20], 100) == 20
    assert evaluate.ng50([10, 10], 100) == 0
    assert evaluate.ng50([], 100) == 0


def test_interior_kmer_recall():
    rng = np.random.default_rng(0)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(genome))
    assert evaluate.interior_kmer_recall(genome, [genome], 31, 50) == 1.0
    # strand-agnostic: the reverse complement covers every k-mer
    assert evaluate.interior_kmer_recall(genome, [rc], 31, 50) == 1.0
    half = evaluate.interior_kmer_recall(genome, [genome[:200]], 31, 50)
    assert 0.3 < half < 0.6
    assert evaluate.interior_kmer_recall(genome, [], 31, 50) == 0.0
    assert len(evaluate.canonical_kmers("ACGTACGTAC", 31)) == 0


def test_differing_files(tmp_path):
    want, got = tmp_path / "want", tmp_path / "got"
    want.mkdir()
    got.mkdir()
    (want / "device.a").write_bytes(b"x")
    (got / "a").write_bytes(b"x")
    (want / "device.b").write_bytes(b"y")
    (got / "b").write_bytes(b"z")
    assert evaluate.differing_files(
        str(want), str(got), ["a", "b", "c"], want_prefix="device."
    ) == ["b", "c"]


def test_make_pairs_shapes_and_gate():
    import chip_smoke

    rng = np.random.default_rng(1)
    reads, r_lens, drafts, d_lens = chip_smoke.make_pairs(rng, 32, 512, 128)
    assert reads.shape == drafts.shape == (32, 512)
    assert (r_lens <= 512).all() and (d_lens <= 512 - 64).all()
    assert (r_lens[-8:] == 0).all() and (d_lens[-8:] == 0).all()
    gate = np.abs(r_lens - d_lens) < 128 // 2 - 4
    assert not gate[0] and not gate[1] and gate[2:24].all()
    for b in range(2, 24):
        assert (reads[b, : r_lens[b]] < 4).all()
        assert (reads[b, r_lens[b]:] == 4).all()


def test_chip_smoke_needs_a_gpu():
    """Without a card the smoke exits non-zero and prints no result."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
