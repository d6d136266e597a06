"""Profile the short-read assembly stage (the minia replacement) alone.

Builds/reuses the synthetic dataset from bench_e2e, then runs
``assemble_short_reads`` with the streaming counter forced on (the regime
the 4.6 Mb e2e uses) and prints the per-phase wall-clock breakdown as one
JSON line.  This is the diagnosis tool for the `assemble_srs` stage that
dominates the end-to-end run.

Usage: python scripts/prof_sr.py [--scale 4600000] [--streaming {auto,1,0}]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from haslr_tpu import runtime  # noqa: E402
from scripts.bench_e2e import build_dataset  # noqa: E402

runtime.init_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=2_300_000)
    ap.add_argument("--data", default="/tmp/haslr_bench_data")
    ap.add_argument("--streaming", default="1", choices=["auto", "1", "0"])
    ap.add_argument("--out", default="/tmp/prof_sr_contigs.fa")
    a = ap.parse_args()

    data_dir = f"{a.data}/{a.scale}"
    t0 = time.time()
    _g, sr_path, _lr = build_dataset(data_dir, a.scale)
    sim_dt = time.time() - t0

    from haslr_tpu.sr import assemble_sr

    streaming = None if a.streaming == "auto" else a.streaming == "1"
    t0 = time.time()
    n = assemble_sr.assemble_short_reads(
        [sr_path], a.out, kmer_size=49, min_abundance=3,
        asm_type="contigs", streaming=streaming,
    )
    wall = time.time() - t0
    prof = {
        k: (round(v, 2) if isinstance(v, (int, float)) else v)
        for k, v in assemble_sr.PROF.items()
    }
    total_bases = a.scale * 40
    print(json.dumps({
        "metric": "sr_stage_wall_s",
        "value": round(wall, 1),
        "scale_bp": a.scale,
        "sr_mbases": round(total_bases / 1e6, 1),
        "mbases_per_s": round(total_bases / 1e6 / wall, 2),
        "n_contigs": n,
        "platform": jax.devices()[0].platform,
        "sim_s": round(sim_dt, 1),
        "prof": prof,
    }))


if __name__ == "__main__":
    main()
