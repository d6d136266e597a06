"""Golden parity fixtures: byte-exact stage artifacts.

The committed dataset (``tests/golden/input``) was constructed so every
graph-cleaning pass fires (see ``tests/golden/make_golden.py``); the
committed expected artifacts (``tests/golden/expected``) pin the
assembler's deterministic stage outputs — ``compact_uniq.txt`` and the
``backbone.NN.*`` GFA/stat cascade — the same diffable snapshots the
reference emits after every stage (main.cpp:133-196).  Any semantic drift
in PAF filtering, scheduling, graph build or cleaning breaks these byte
comparisons.
"""

import gzip
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "golden"))

from make_golden import (  # noqa: E402
    GOLDEN_ARTIFACTS,
    GOLDEN_DEVICE_ARTIFACTS,
)


def _gunzip(src, dst):
    with gzip.open(src, "rb") as fi, open(dst, "wb") as fo:
        fo.write(fi.read())


def test_stage_artifacts_match_golden(tmp_path):
    from haslr_tpu.assemble.pipeline import run_assembler
    from haslr_tpu.config import AssembleConfig

    in_dir = os.path.join(HERE, "golden", "input")
    exp_dir = os.path.join(HERE, "golden", "expected")
    contig_path = str(tmp_path / "contigs.fa")
    lr_path = str(tmp_path / "lr.fa")
    paf_path = str(tmp_path / "map.paf")
    _gunzip(f"{in_dir}/contigs.fa.gz", contig_path)
    _gunzip(f"{in_dir}/lr.fa.gz", lr_path)
    _gunzip(f"{in_dir}/map.paf.gz", paf_path)

    out = str(tmp_path / "asm")
    cfg = AssembleConfig(consensus_engine="poa")
    run_assembler(contig_path, lr_path, paf_path, out, cfg=cfg, log=None)

    mismatches = []
    for name in GOLDEN_ARTIFACTS:
        with open(f"{exp_dir}/{name}", "rb") as f:
            want = f.read()
        with open(f"{out}/{name}", "rb") as f:
            got = f.read()
        if want != got:
            mismatches.append(name)
    assert not mismatches, f"stage artifacts diverged: {mismatches}"

    # the device (dense) engine's final sequences, pinned separately
    out_dev = str(tmp_path / "asm_device")
    cfg_dev = AssembleConfig(consensus_engine="device")
    run_assembler(
        contig_path, lr_path, paf_path, out_dev, cfg=cfg_dev, log=None
    )
    for name in GOLDEN_DEVICE_ARTIFACTS:
        with open(f"{exp_dir}/device.{name}", "rb") as f:
            want = f.read()
        with open(f"{out_dev}/{name}", "rb") as f:
            got = f.read()
        if want != got:
            mismatches.append(f"device.{name}")
    assert not mismatches, f"final outputs diverged: {mismatches}"


def test_golden_fixture_exercises_every_cleaning_pass():
    """The fixture must keep covering the full cascade: each cleaning
    stage's stat snapshot strictly shrinks the graph."""
    exp_dir = os.path.join(HERE, "golden", "expected")

    def n_edges(stat):
        with open(f"{exp_dir}/{stat}") as f:
            for line in f:
                if line.startswith("edges:"):
                    return int(line.split(":")[1])
        raise AssertionError(f"no edge count in {stat}")

    seq = [
        "backbone.01.init.stat",
        "backbone.02.weakEdge.stat",
        "backbone.03.tip.stat",
        "backbone.04.simplebubble.stat",
        "backbone.05.superbubble.stat",
        "backbone.06.smallbubble.stat",
    ]
    counts = [n_edges(s) for s in seq]
    assert all(a > b for a, b in zip(counts, counts[1:])), counts
