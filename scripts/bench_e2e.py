"""End-to-end benchmark at E. coli scale (BASELINE.json config #1 analog).

Generates (and caches) a synthetic 4.6 Mb dataset — 30 repeat families x 8
exact copies, 40x Illumina-like short reads, 15x PacBio-like long reads at
6% error — then runs the full CLI pipeline and reports wall-clock,
per-stage times, NG50, and interior k-mer recall as ONE JSON line.

The reference's quick start (its only documented end-to-end run,
reference README.md:86-96) uses the real E. coli dataset; this synthetic
mirror has the same genome size, comparable repeat structure, and the
same pipeline defaults (-g 4.6m -x pacbio, k=49, cov-lr 25).  Nothing is
downloaded.

Usage: python scripts/bench_e2e.py [--scale 4600000] [--data DIR] [--out DIR]
       [--platform {gpu,cpu}]
"""

import argparse
import faulthandler
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def build_dataset(data_dir, genome_len, seed=7):
    """Simulate and cache the dataset; returns (genome_path, sr, lr)."""
    from haslr_tpu.testutil import simulate

    g_path = f"{data_dir}/genome.txt"
    sr_path = f"{data_dir}/sr.fq"
    lr_path = f"{data_dir}/lr.fa"
    if all(os.path.isfile(p) for p in (g_path, sr_path, lr_path)):
        return g_path, sr_path, lr_path
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_fam = max(2, genome_len // 153_000)  # ~30 families at 4.6 Mb
    genome = simulate.genome_with_repeats(
        rng, genome_len, n_families=n_fam, copies_per_family=8,
        repeat_len=400,
    )
    with open(g_path + ".tmp", "w") as fp:
        fp.write(genome)
    srs = simulate.make_short_reads(rng, genome, coverage=40.0)
    simulate.write_short_reads(sr_path, srs)
    del srs
    lrs = simulate.make_reads(
        rng, genome, coverage=15.0, mean_len=9000, error_rate=0.06,
        traced=False,
    )
    with open(lr_path, "w") as fp:
        for r in lrs:
            fp.write(f">sim{r.rid}\n{r.seq}\n")
    os.replace(g_path + ".tmp", g_path)
    return g_path, sr_path, lr_path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=4_600_000)
    ap.add_argument("--data", default="/tmp/haslr_bench_data")
    ap.add_argument("--out", default="/tmp/haslr_bench_out")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--keep-out", action="store_true")
    # the other BASELINE.json configs: S. cerevisiae/D. melanogaster are
    # nanopore (-x nanopore), C. elegans runs --minia-asm unitigs
    ap.add_argument("--read-type", default="pacbio",
                    choices=["pacbio", "nanopore", "corrected"])
    ap.add_argument("--minia-asm", default="contigs",
                    choices=["contigs", "unitigs"])
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    a = ap.parse_args()
    # long runs at new scales can stall where no profiler reaches: dump
    # every thread's stack to stderr every 10 minutes
    faulthandler.dump_traceback_later(600, repeat=True)

    data_dir = f"{a.data}/{a.scale}"
    t0 = time.time()
    g_path, sr_path, lr_path = build_dataset(data_dir, a.scale)
    sim_dt = time.time() - t0

    if not a.keep_out and os.path.isdir(a.out):
        shutil.rmtree(a.out)

    from haslr_tpu.cli.haslr import main as cli_main

    t0 = time.time()
    rc = cli_main([
        "-o", a.out, "-g", str(a.scale), "-l", lr_path, "-x", a.read_type,
        "-s", sr_path, "-t", str(a.threads), "--minia-asm", a.minia_asm,
        "--platform", a.platform,
    ])
    wall = time.time() - t0
    assert rc == 0, f"pipeline failed rc={rc}"

    from haslr_tpu.core import io as cio
    from haslr_tpu.testutil import evaluate

    import glob

    final = glob.glob(f"{a.out}/asm_*/asm.final.fa")[0]
    recs = list(cio.read_fastx(final))
    lens = [len(r.seq) for r in recs]
    genome = open(g_path).read().strip()
    recall = evaluate.interior_kmer_recall(genome, [r.seq for r in recs])

    from haslr_tpu.cli import haslr as cli_mod

    # per-phase breakdown of the two heaviest stages: the SR
    # counter/compactor phases and the aligner's seed/extend/emit
    # phases, captured from the module PROF dicts the in-process CLI
    # left behind
    phase_prof = {}
    try:
        from haslr_tpu.sr import assemble_sr

        phase_prof["assemble_srs"] = {
            k: (round(v, 2) if isinstance(v, (int, float)) else v)
            for k, v in assemble_sr.PROF.items()
        }
    except Exception:
        pass
    try:
        from haslr_tpu.aligner import map as amap

        phase_prof["align_lr_src"] = {
            k: round(v, 2) for k, v in amap.PROF.items()
        }
    except Exception:
        pass

    print(json.dumps({
        "metric": "e2e_wall_s",
        "value": round(wall, 1),
        "unit": "s",
        "scale_bp": a.scale,
        "read_type": a.read_type,
        "minia_asm": a.minia_asm,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "n_contigs": len(recs),
        "total_bp": int(sum(lens)),
        "ng50": evaluate.ng50(lens, len(genome)),
        "kmer_recall": round(recall, 5),
        "sim_s": round(sim_dt, 1),
        "stages_s": {
            k: round(v, 1) for k, v in cli_mod.STAGE_TIMES.items()
        },
        "stage_phases": phase_prof,
    }))


if __name__ == "__main__":
    main()
