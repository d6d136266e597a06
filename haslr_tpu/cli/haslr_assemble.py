"""Standalone core-assembler CLI — the ``haslr_assemble`` equivalent.

Same options as the reference binary (``Commandline.cpp:68-242``):

    python -m haslr_tpu.cli.haslr_assemble -c contigs.fa -l lr.fa \\
        -m map.paf -d outdir [--aln-block N] [--aln-sim F] [--uniq-dev F] \\
        [--edge-sup N] [-t N] [--long-fofn] [--mapping-fofn]
"""

from __future__ import annotations

import argparse
import sys

from haslr_tpu import __version__
from haslr_tpu.config import AssembleConfig


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="haslr_assemble",
        usage=(
            "haslr_assemble -c contig.fasta -l longread.fasta -m "
            "lr2contig.paf -d outdir [options]"
        ),
    )
    p.add_argument("-c", "--contig", required=True)
    p.add_argument("-l", "--long", required=True)
    p.add_argument("-m", "--mapping", required=True)
    p.add_argument("-d", "--dir", required=True)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--aln-block", type=int, default=500)
    p.add_argument("--aln-sim", type=float, default=0.85)
    p.add_argument("--uniq-dev", type=float, default=0.15)
    p.add_argument("--edge-sup", type=int, default=3)
    p.add_argument("--long-fofn", action="store_true")
    p.add_argument("--mapping-fofn", action="store_true")
    p.add_argument("--resolve-repeats", action="store_true")
    p.add_argument("--bridge-sup", type=int, default=2)
    p.add_argument("--consensus-engine", default="device",
                   choices=["device", "poa"])
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--version", action="version", version=__version__)
    a = p.parse_args(argv)
    from haslr_tpu import runtime

    runtime.select_platform(a.platform)
    runtime.init_compile_cache()
    # defaults-on-invalid, mirroring Commandline.cpp:148-175
    if a.aln_block < 0:
        a.aln_block = 500
    if not (0 <= a.aln_sim <= 1):
        a.aln_sim = 0.85
    if a.edge_sup < 0:
        a.edge_sup = 3

    from haslr_tpu.assemble.pipeline import run_assembler

    cfg = AssembleConfig(
        min_aln_block=a.aln_block,
        min_aln_sim=a.aln_sim,
        max_uniq_dev=a.uniq_dev,
        min_edge_sup=a.edge_sup,
        num_threads=max(1, a.threads),
        consensus_engine=a.consensus_engine,
        resolve_repeats=a.resolve_repeats,
        min_bridge_support=a.bridge_sup,
    )
    print(f"[NOTE] number of threads: {cfg.num_threads}\n", file=sys.stderr)
    stats = run_assembler(
        a.contig, a.long, a.mapping, a.dir, cfg=cfg,
        long_fofn=a.long_fofn, mapping_fofn=a.mapping_fofn,
    )
    print("*** BYE ***\n", file=sys.stderr)
    return 0 if stats else 1


if __name__ == "__main__":
    sys.exit(main())
