"""Cross-validation of the WHOLE graph stack against the reference
binary itself.

``haslr_assemble`` normally cannot be built offline (its Makefile
git-clones SPOA, ``src/haslr_assemble/Makefile:40-46``), but SPOA is
only reached by the consensus stage — every artifact BEFORE it
(``compact_uniq.txt``, ``backbone.01..06`` GFAs/stats, the cleaning
logs) depends solely on in-repo reference sources.  This test compiles
the reference's own sources verbatim against a 40-line STUB spoa
(``tests/crossval/spoa_stub.hpp`` — original code, consensus output
meaningless), runs the real binary and our assembler on the SAME inputs
(produced by our pipeline on a simulated dataset), and asserts the
graph-stage artifacts are byte-identical — reference-generated truth
for compaction, backbone construction, and all five cleaning passes
(round-4 verdict missing #3; previously only ``nooverlap`` had a
reference oracle).

Reference sequencing pinned here: ``main.cpp:109-199`` (fix overlaps ->
compact -> backbone -> weak -> tip -> simple -> super -> small),
``bin/haslr.py:66`` (haslr_assemble consumes the UNfiltered nooverlap
contigs; only minimap2's target is length-filtered, ``bin/haslr.py:87``).
"""

import glob
import os
import shutil
import subprocess

import numpy as np
import pytest

REF_SRC = "/root/reference/src/haslr_assemble/src"
STUB = os.path.join(os.path.dirname(__file__), "crossval", "spoa_stub.hpp")

ARTIFACTS = [
    "compact_uniq.txt",
    "backbone.01.init.gfa", "backbone.01.init.stat",
    "backbone.02.weakEdge.gfa", "backbone.02.weakEdge.stat",
    "backbone.03.tip.gfa", "backbone.03.tip.stat", "backbone.03.tip.log",
    "backbone.04.simplebubble.gfa", "backbone.04.simplebubble.stat",
    "backbone.04.simplebubble.log",
    "backbone.05.superbubble.gfa", "backbone.05.superbubble.stat",
    "backbone.05.superbubble.log",
    "backbone.06.smallbubble.gfa", "backbone.06.smallbubble.stat",
    "backbone.06.smallbubble.log",
    "backbone.branching.log",
]


@pytest.fixture(scope="module")
def ref_binary(tmp_path_factory):
    if not os.path.isdir(REF_SRC) or shutil.which("g++") is None:
        pytest.skip("reference source or g++ unavailable")
    d = tmp_path_factory.mktemp("haslr_assemble_ref")
    for f in os.listdir(REF_SRC):
        if f.endswith((".cpp", ".hpp", ".h")):
            shutil.copy(os.path.join(REF_SRC, f), d)
    shutil.copy(STUB, d / "spoa.hpp")
    exe = d / "haslr_assemble_stub"
    srcs = [
        "main.cpp", "Common.cpp", "Commandline.cpp",
        "Compressed_sequence.cpp", "Contig.cpp", "Longread.cpp",
        "Backbone_graph.cpp", "Cleaning.cpp", "Assemble.cpp",
    ]
    res = subprocess.run(
        ["g++", "-O2", "-std=c++11", "-I", "."] + srcs
        + ["-lz", "-lpthread", "-o", str(exe)],
        cwd=d, capture_output=True,
    )
    if res.returncode != 0:
        pytest.skip(f"reference build failed: {res.stderr.decode()[:300]}")
    return str(exe)


def test_graph_stages_byte_identical_to_reference(ref_binary, tmp_path):
    from haslr_tpu.cli.haslr import main as cli_main
    from haslr_tpu.testutil import simulate

    rng = np.random.default_rng(31)
    genome = simulate.genome_with_repeats(
        rng, 80_000, n_families=3, copies_per_family=4, repeat_len=400
    )
    srs = simulate.make_short_reads(rng, genome, coverage=40.0)
    sr = str(tmp_path / "sr.fq")
    simulate.write_short_reads(sr, srs)
    lrs = simulate.make_reads(
        rng, genome, coverage=15.0, mean_len=8000, error_rate=0.06
    )
    lr = str(tmp_path / "lr.fa")
    with open(lr, "w") as fp:
        for r in lrs:
            fp.write(f">sim{r.rid}\n{r.seq}\n")

    out = str(tmp_path / "ours")
    rc = cli_main(["-o", out, "-g", "80k", "-l", lr, "-x", "pacbio",
                   "-s", sr, "--platform", "cpu"])
    assert rc == 0
    ours_dir = glob.glob(f"{out}/asm_*")[0]
    noov = glob.glob(f"{out}/sr_*.contigs.nooverlap.fa")[0]
    lr25 = f"{out}/lr25x.fasta"
    paf = glob.glob(f"{out}/map_*.paf")[0]

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    res = subprocess.run(
        [ref_binary, "-c", noov, "-l", lr25, "-m", paf,
         "-d", str(ref_dir), "-t", "1"],
        capture_output=True,
    )
    assert res.returncode == 0, res.stderr.decode()[-500:]

    for f in ARTIFACTS:
        ref_f = ref_dir / f
        our_f = os.path.join(ours_dir, f)
        assert ref_f.is_file(), f"reference did not write {f}"
        assert os.path.isfile(our_f), f"our assembler did not write {f}"
        with open(ref_f, "rb") as fa, open(our_f, "rb") as fb:
            a, b = fa.read(), fb.read()
        assert a == b, f"{f} differs from the reference binary's output"
