"""Time the row-scan DP with and without the CUDA kernel, end to end, on
one GPU, in turns (XLA, kernel, kernel, XLA):

- the ``bench.py`` consensus workload (4096 windows x 13 reads x ~300 bp,
  S = 512): wall of ``batched_consensus``;
- the extension stage of the 4.6 Mb deployment: wall of
  ``batch_align_segments`` over every NW segment the aligner produces on
  the ``scripts/bench_e2e.py`` dataset;
- the DP + traceback alone at one production dispatch shape each for
  consensus (mapping, S = 512) and extension (CIGAR runs, S = 1024),
  8192 reads, inputs already on the card, timed around
  ``block_until_ready`` (REPS runs per turn).

Each turn recompiles (warm-up run, not timed) and then times one run.
Both modes must produce identical outputs.  Prints one line per timed
run, naming the card and its power limit, then one JSON summary line.

Usage: python scripts/compare_rowscan.py [--scale 4600000] [--data DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ORDER = ("xla", "kernel", "kernel", "xla")
REPS = 5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _set_mode(mode):
    import jax

    from haslr_tpu.kernels import nw_rowscan as rs

    if mode == "kernel":
        rs.use_kernel = _use_kernel
    else:
        rs.use_kernel = lambda R, D, W: False
    jax.clear_caches()


def _turns(card, name, run):
    """run() -> (output, phase dict); returns the timed walls per mode."""
    walls = {"xla": [], "kernel": []}
    ref = None
    for mode in ORDER:
        _set_mode(mode)
        run()  # compile + warm
        t0 = time.time()
        out, phases = run()
        dt = time.time() - t0
        walls[mode].append(dt)
        if ref is None:
            ref = out
        assert out == ref, f"{name}: {mode} output differs"
        print(f"[{card}] {name} {mode}: {dt:.3f} s {json.dumps(phases)}",
              flush=True)
    return walls


def _dp_alone(card):
    """DP + traceback alone, REPS runs per turn; returns the walls of
    each turn (seconds for REPS runs) per shape."""
    import jax
    import numpy as np

    import chip_smoke
    from haslr_tpu.kernels import nw_rowscan as rs

    rng = np.random.default_rng(11)
    walls = {}
    for S, kind in ((512, "mapping"), (1024, "cigar")):
        args = [jax.device_put(x)
                for x in chip_smoke.make_pairs(rng, 8192, S, 128)]
        if kind == "mapping":
            fn = jax.jit(rs.rowscan_mapping, static_argnums=range(4, 10))
            scores = (S, S, 128, 5, -4, -8)
        else:
            fn = jax.jit(rs.rowscan_cigar, static_argnums=range(4, 11))
            scores = (S, S, 128, 2, -4, -2, rs.default_maxr(S))

        def run():
            for _ in range(REPS):
                out = jax.block_until_ready(fn(*args, *scores))
            return [np.asarray(o).tobytes() for o in jax.tree.leaves(out)], {}

        walls[f"dp_{kind}_S{S}_B8192_x{REPS}_s"] = _turns(
            card, f"dp {kind} S={S} B=8192 x{REPS}", run
        )
    return walls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=4_600_000)
    ap.add_argument("--data", default=None)
    a = ap.parse_args()

    from haslr_tpu import runtime

    runtime.select_platform("gpu")
    runtime.init_compile_cache()

    import bench
    from haslr_tpu.aligner import extend
    from haslr_tpu.aligner import map as amap
    from haslr_tpu.cli import haslr as cli
    from haslr_tpu.config import PipelineConfig
    from haslr_tpu.kernels import consensus_dense as cd
    from haslr_tpu.kernels import nw_rowscan as rs
    from haslr_tpu.kernels.consensus import batched_consensus
    from scripts.bench_e2e import build_dataset

    global _use_kernel
    _use_kernel = rs.use_kernel
    card = _card()
    summary = {"card": card}

    windows = bench.make_windows()

    def consensus():
        cd.PROF.clear()
        out = batched_consensus(windows)
        return out, {k: round(v, 3) for k, v in cd.PROF.items()}

    summary["consensus_s"] = _turns(card, "consensus", consensus)

    threads = os.cpu_count() or 1
    with tempfile.TemporaryDirectory(prefix="haslr_cmp_") as tmp:
        data = a.data or os.path.join(tmp, "data")
        _g, sr, lr = build_dataset(data, a.scale)
        cfg = PipelineConfig(
            out=os.path.join(tmp, "out"), genome=str(a.scale), long=(lr,),
            short=(sr,), threads=threads,
        )
        os.makedirs(cfg.out)
        lr_file = cli.prepare_lrs(cfg)
        cli.assemble_srs(cfg)
        _noov, good = cli.remove_short_src(cfg)
        t0 = time.time()
        _pending, segments = amap._seed_chain_shards(
            good, lr_file, "pacbio", 40.0, threads
        )
        print(f"{len(segments)} extension segments "
              f"(seed+chain {time.time() - t0:.1f} s)", flush=True)

    def extension():
        res = extend.batch_align_segments(segments)
        out = [(o.tobytes(), l.tobytes(), ne) for o, l, ne in res]
        return out, {k: round(v, 3) for k, v in extend.PROF.items()}

    summary["extension_s"] = _turns(card, "extension", extension)
    summary["n_segments"] = len(segments)
    summary.update(_dp_alone(card))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
