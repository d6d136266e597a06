"""End-to-end pipeline driver — the ``haslr.py`` equivalent.

Same five stages, same parameterized artifact names, same skip-if-exists
resume semantics as the reference driver (``bin/haslr.py:18-50``):

1. prepare long reads (subsample to ``--cov-lr`` coverage, numeric ids) —
   ``lr{cov}x.fasta`` (bin/haslr.py:204-260);
2. assemble short reads — ``sr_k{K}_a{A}.{contigs|unitigs}.fa``
   (bin/haslr.py:160-200, minia replacement);
3. trim contig overlaps + drop short contigs —
   ``*.nooverlap.fa`` / ``*.nooverlap.{min}.fa`` (bin/haslr.py:115-156);
4. align long reads to contigs — ``map_*.paf`` (bin/haslr.py:81-110,
   minimap2 replacement);
5. run the core assembler — ``asm_*/asm.final.fa`` (bin/haslr.py:54-77).

Every stage is skipped when its output already exists, so an interrupted
run resumes where it stopped (reference README.md:143).

Usage::

    python -m haslr_tpu.cli.haslr -o OUT -g 4.6m -l LR.fa -x pacbio -s SR.fq
"""

from __future__ import annotations

import argparse
import os
import sys

from haslr_tpu.config import PipelineConfig, parse_genome_size


def _stamp(msg: str):
    import datetime

    now = datetime.datetime.now().strftime("%d-%b-%Y %H:%M:%S")
    sys.stdout.write(f"[{now}] {msg}")
    sys.stdout.flush()


def _done(skipped=False):
    sys.stdout.write("already exists\n" if skipped else "done\n")
    sys.stdout.flush()


def prepare_lrs(cfg: PipelineConfig) -> str:
    from haslr_tpu.sr import fastutils

    lr_name = "lrall" if cfg.cov_lr == 0 else f"lr{cfg.cov_lr}x"
    lr_file = f"{cfg.out}/{lr_name}.fasta"
    if cfg.cov_lr == 0:
        _stamp(f"renaming long reads and storing in {lr_file}... ")
        if not os.path.isfile(lr_file):
            fastutils.format_rename(list(cfg.long), lr_file)
            _done()
        else:
            _done(skipped=True)
    else:
        _stamp(f"subsampling {cfg.cov_lr}x long reads to {lr_file}... ")
        if not os.path.isfile(lr_file):
            fastutils.subsample_longest(
                list(cfg.long), lr_file, cfg.cov_lr,
                parse_genome_size(cfg.genome),
            )
            _done()
        else:
            _done(skipped=True)
    return lr_file


def _get_mesh(cfg: PipelineConfig):
    """The dp mesh the device stages shard over (None = single device)."""
    if cfg.devices == 1:
        return None
    from haslr_tpu.dist.mesh import make_mesh

    return make_mesh(None if cfg.devices == 0 else cfg.devices)


def assemble_srs(cfg: PipelineConfig) -> str:
    from haslr_tpu.sr.assemble_sr import assemble_short_reads

    prefix = f"{cfg.out}/sr_k{cfg.minia_kmer}_a{cfg.minia_solid}"
    sr_asm = f"{prefix}.{cfg.minia_asm}.fa"
    _stamp("assembling short reads... ")
    if not os.path.isfile(sr_asm):
        assemble_short_reads(
            list(cfg.short), sr_asm,
            kmer_size=cfg.minia_kmer,
            min_abundance=cfg.minia_solid,
            asm_type=cfg.minia_asm,
            mesh=_get_mesh(cfg),
        )
        _done()
    else:
        _done(skipped=True)
    return sr_asm


def remove_short_src(cfg: PipelineConfig) -> tuple[str, str]:
    """Returns (nooverlap_fasta, length_filtered_fasta).

    Note the reference's asymmetry (bin/haslr.py:60,87): the aligner
    targets the length-filtered file but the core assembler loads the
    *unfiltered* nooverlap file — contig ids in the PAF are minia's
    sequential names, which match file order only in the unfiltered file.
    """
    from haslr_tpu.sr import fastutils, nooverlap

    prefix = f"{cfg.out}/sr_k{cfg.minia_kmer}_a{cfg.minia_solid}"
    sr_asm = cfg.contig if cfg.contig else f"{prefix}.{cfg.minia_asm}.fa"
    noov = f"{prefix}.{cfg.minia_asm}.nooverlap.fa"
    _stamp("removing overlaps in short read assembly... ")
    if not os.path.isfile(noov):
        nooverlap.remove_overlaps(sr_asm, noov, cfg.minia_kmer)
        _done()
    else:
        _done(skipped=True)
    good = f"{prefix}.{cfg.minia_asm}.nooverlap.{cfg.min_src}.fa"
    _stamp("removing short sequences in short read assembly... ")
    if not os.path.isfile(good):
        fastutils.format_min_len(noov, good, cfg.min_src)
        _done()
    else:
        _done(skipped=True)
    return noov, good


def align_lr_src(cfg: PipelineConfig, lr_file: str, src_file: str) -> str:
    from haslr_tpu.aligner import map_reads

    lr_name = "lrall" if cfg.cov_lr == 0 else f"lr{cfg.cov_lr}x"
    paf = (
        f"{cfg.out}/map_{cfg.minia_asm}_k{cfg.minia_kmer}_a{cfg.minia_solid}"
        f"_c{cfg.min_src}_{lr_name}.paf"
    )
    _stamp("aligning long reads to short read assembly... ")
    if not os.path.isfile(paf):
        map_reads(
            src_file, lr_file, paf, read_type=cfg.type,
            threads=cfg.threads, mesh=_get_mesh(cfg),
        )
        _done()
    else:
        _done(skipped=True)
    return paf


def assemble_lr(cfg: PipelineConfig, lr_file: str, src_file: str,
                paf: str) -> str:
    from haslr_tpu.assemble.pipeline import run_assembler

    lr_name = "lrall" if cfg.cov_lr == 0 else f"lr{cfg.cov_lr}x"
    asm_dir = (
        f"{cfg.out}/asm_{cfg.minia_asm}_k{cfg.minia_kmer}_a{cfg.minia_solid}"
        f"_c{cfg.min_src}_{lr_name}_b{cfg.aln_block}_s{cfg.edge_sup}"
        f"_sim{cfg.aln_sim}"
    )
    _stamp("assembling long reads using HASLR... ")
    if not os.path.isfile(f"{asm_dir}/asm.final.fa"):
        with open(asm_dir + ".err", "w") as err:
            run_assembler(
                src_file, lr_file, paf, asm_dir,
                cfg=cfg.assemble_config(), log=err, mesh=_get_mesh(cfg),
            )
        _done()
    else:
        _done(skipped=True)
    return f"{asm_dir}/asm.final.fa"


# wall-clock per stage of the last run_pipeline call (the per-stage
# breakdown scripts/bench_e2e.py records; the reference's driver
# timestamps each stage the same way, bin/haslr.py:55-82)
STAGE_TIMES: dict[str, float] = {}


def run_pipeline(cfg: PipelineConfig) -> str:
    import time

    os.makedirs(cfg.out, exist_ok=True)
    sys.stdout.write(f"number of threads: {cfg.threads}\n")
    sys.stdout.write(f"output directory: {cfg.out}\n")
    STAGE_TIMES.clear()
    t = time.time()
    lr_file = prepare_lrs(cfg)
    STAGE_TIMES["prepare_lrs"] = time.time() - t
    if cfg.contig is None:
        t = time.time()
        assemble_srs(cfg)
        STAGE_TIMES["assemble_srs"] = time.time() - t
    t = time.time()
    noov_file, good_file = remove_short_src(cfg)
    STAGE_TIMES["remove_short_src"] = time.time() - t
    t = time.time()
    paf = align_lr_src(cfg, lr_file, good_file)
    STAGE_TIMES["align_lr_src"] = time.time() - t
    t = time.time()
    out = assemble_lr(cfg, lr_file, noov_file, paf)
    STAGE_TIMES["assemble_lr"] = time.time() - t
    return out


def parse_options(argv=None) -> PipelineConfig:
    p = argparse.ArgumentParser(
        prog="haslr",
        usage=(
            "haslr [-t THREADS] -o OUT_DIR -g GENOME_SIZE -l LONG [LONG ...]"
            " -x LONG_TYPE -s SHORT [SHORT ...]"
        ),
    )
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-l", "--long", nargs="+", required=True)
    p.add_argument(
        "-x", "--type", required=True,
        choices=["pacbio", "nanopore", "corrected"],
    )
    p.add_argument("-s", "--short", nargs="+")
    p.add_argument("-c", "--contig")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--cov-lr", type=int, default=25)
    p.add_argument("--aln-block", type=int, default=500)
    p.add_argument("--aln-sim", type=float, default=0.85)
    p.add_argument("--edge-sup", type=int, default=3)
    p.add_argument("--minia-kmer", type=int, default=49)
    p.add_argument("--minia-solid", type=int, default=3)
    p.add_argument("--minia-asm", default="contigs",
                   choices=["contigs", "unitigs"])
    p.add_argument("--min-src", type=int, default=250)
    p.add_argument("--short-fofn", action="store_true")
    p.add_argument("--long-fofn", action="store_true")
    p.add_argument(
        "--platform", default="gpu", choices=["gpu", "cpu"],
        help="where the device stages run: gpu (CUDA; an error without a"
             " card) or cpu",
    )
    p.add_argument(
        "--devices", type=int, default=1,
        help="device-mesh width for the device stages (k-mer merge, aligner"
             " extension, consensus); 0 = all visible devices",
    )
    a = p.parse_args(argv)
    from haslr_tpu import runtime

    runtime.select_platform(a.platform)
    runtime.init_compile_cache()
    if a.short is None and a.contig is None:
        p.error("either -s/--short or -c/--contig is required")
    longs = list(a.long)
    shorts = list(a.short or [])
    if a.long_fofn:
        from haslr_tpu.core.io import read_fofn

        longs = [f for fn in longs for f in read_fofn(fn)]
    if a.short_fofn:
        from haslr_tpu.core.io import read_fofn

        shorts = [f for fn in shorts for f in read_fofn(fn)]
    for fn in longs + shorts + ([a.contig] if a.contig else []):
        if not os.path.isfile(fn):
            p.error(f"could not find file {fn}")
    return PipelineConfig(
        out=os.path.abspath(a.out),
        genome=a.genome,
        long=tuple(os.path.abspath(f) for f in longs),
        type=a.type,
        short=tuple(os.path.abspath(f) for f in shorts),
        contig=os.path.abspath(a.contig) if a.contig else None,
        threads=max(1, a.threads),
        cov_lr=a.cov_lr,
        aln_block=a.aln_block,
        aln_sim=a.aln_sim,
        edge_sup=a.edge_sup,
        minia_kmer=a.minia_kmer,
        minia_solid=a.minia_solid,
        minia_asm=a.minia_asm,
        min_src=a.min_src,
        devices=a.devices,
    )


def main(argv=None):
    cfg = parse_options(argv)
    out = run_pipeline(cfg)
    sys.stdout.write(f"final assembly: {out}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
