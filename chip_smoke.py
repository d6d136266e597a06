#!/usr/bin/env python3
"""Smoke test of the assembler on an NVIDIA GPU, through the entry points
a user calls.

One card (no arguments), three phases, each a hard assertion:

(a) environment: JAX's devices, the card's name and power limit, the
    native library and the CUDA row-scan kernel built, the compile cache;
(b) kernels against the plain reference at real widths: the production
    row-scan DP + traceback (CUDA kernel for the W = 128 buckets, XLA scan
    for W = 256/512) on the card against the XLA scan on the CPU backend
    of the same process, mapping and CIGAR runs, at four bucket shapes
    with 4096 reads each; then the device consensus on the golden fixture
    against the committed goldens;
(c) end to end: ``haslr_tpu.cli.haslr`` on the 4.6 Mb E. coli-scale
    synthetic deployment (-g 4.6m -x pacbio, k 49, cov-lr 25), NG50 and
    interior 31-mer recall against the simulated genome, wall and stage
    times, the memory of one consensus dispatch program, peak device memory
    (run before (b), so the peak is the end-to-end run's own).

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits non-zero and prints no result.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # four cards: the 4.6 Mb CLI with
                                       # --devices 4 and 1, PAF and
                                       # asm.final.fa byte-identical
    python chip_smoke.py --rehearse    # CPU rehearsal at a small size;
                                       # prints no device result
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (S, W) buckets compared in phase (b): both kernel widths' largest
# consensus/extension buckets and the two XLA-only widths
SHAPES = ((512, 128), (1024, 128), (2048, 256), (16384, 512))
B_CMP = 4096
# rows the CPU reference recomputes per shape (rows are independent; the
# XLA scan on the CPU at 16384 x 4096 would need 34 GB of directions)
CPU_ROWS = {512: 4096, 1024: 4096, 2048: 512, 16384: 32}
GENOME_LEN = 4_600_000
NG50_MIN_FRACTION = 4.0 / 4.6   # NG50 >= 4.0 Mb at 4.6 Mb
RECALL_MIN = 0.999


def _require(ok, what: str) -> None:
    """A phase's check; unlike ``assert`` it survives ``python -O``."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _card() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        raise SystemExit(f"nvidia-smi failed: {res.stderr.strip()}")
    return " | ".join(res.stdout.strip().splitlines())


def _start_jax(rehearse: bool, n_dev: int):
    import jax

    jax.config.update("jax_platforms", "cpu" if rehearse else "cuda,cpu")
    if rehearse:
        jax.config.update("jax_num_cpu_devices", n_dev)
    if not rehearse and jax.default_backend() != "gpu":
        # "cuda,cpu" quietly yields the CPU when no card starts
        raise SystemExit(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}"
        )
    from haslr_tpu import runtime

    runtime.init_compile_cache()
    return jax


def phase_env(jax, rehearse: bool) -> str:
    from haslr_tpu import native, runtime

    devs = jax.devices()
    print(f"jax {jax.__version__}: {devs}")
    print(f"device_kind: {devs[0].device_kind} x{len(devs)}")
    card = "cpu rehearsal" if rehearse else _card()
    print(f"nvidia-smi: {card}")
    lib = native.get_lib()
    _require(lib is not None,
             f"native library did not build: {native.BUILD_ERROR}")
    built = native.BUILD_SECONDS
    print(f"native libhaslr.so loaded ("
          f"{'built in %.1f s' % built if built else 'already built'})")
    if not rehearse:
        from haslr_tpu.kernels import rowscan_gpu

        rowscan_gpu.load()
        built = rowscan_gpu.BUILD_SECONDS
        print(f"CUDA row-scan kernel loaded ("
              f"{'built in %.1f s' % built if built else 'already built'})")
    print(f"compile cache: {runtime.compile_cache_dir()}")
    return card


def make_pairs(rng, B: int, S: int, W: int):
    """B read/draft pairs for bucket S: drafts of S/2 .. S - W/2 bases,
    reads at 6% error (2% each substitution, insertion, deletion), rows
    0-1 outside the band-admission gate, the last 8 rows padding."""
    reads = np.full((B, S), 4, np.uint8)
    drafts = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.zeros(B, np.int32)
    for b in range(B - 8):
        dl = int(rng.integers(S // 2, S - W // 2))
        d = rng.integers(0, 4, dl).astype(np.uint8)
        u = rng.random(dl)
        keep = u >= 0.02
        r, u = d[keep].copy(), u[keep]
        sub = u < 0.04
        r[sub] = rng.integers(0, 4, int(sub.sum()))
        ins = (u >= 0.04) & (u < 0.06)
        rep = 1 + ins.astype(np.int64)
        r = np.repeat(r, rep)
        r[(np.cumsum(rep) - 1)[ins]] = rng.integers(0, 4, int(ins.sum()))
        r = r[:S]
        drafts[b, :dl] = d
        reads[b, : len(r)] = r
        d_lens[b] = dl
        r_lens[b] = len(r)
    r_lens[0] = 60
    r_lens[1], d_lens[1] = S - W // 2, 60
    return reads, r_lens, drafts, d_lens


def phase_kernels(jax, card: str, rehearse: bool):
    """Production row scan on the default device vs the XLA scan on the
    CPU backend.  The tolerance is exact equality: DP scores, directions,
    mappings and run lists are integers computed by integer max/add/
    compare, so no rounding or summation order can enter."""
    from haslr_tpu.kernels import nw_rowscan as rs

    cpu = jax.devices("cpu")[0]
    dev_map = jax.jit(rs.rowscan_mapping, static_argnums=range(4, 10))
    ref_map = jax.jit(rs._rowscan_mapping_inner, static_argnums=range(4, 10))
    ref_cig = jax.jit(rs._rowscan_cigar_inner, static_argnums=range(4, 11))
    shapes = SHAPES[:1] + SHAPES[2:3] if rehearse else SHAPES
    B = 64 if rehearse else B_CMP
    rng = np.random.default_rng(2024)
    for S, W in shapes:
        t0 = time.time()
        reads, r_lens, drafts, d_lens = make_pairs(rng, B, S, W)
        maxr = rs.default_maxr(S)
        # device batches below 8 GiB of XLA directions (two copies)
        step = max(1, min(B, (8 << 30) // (2 * (S + 1) * W)))
        got_map, got_runs, got_n = [], [], []
        for lo in range(0, B, step):
            sl = slice(lo, lo + step)
            a = (reads[sl], r_lens[sl], drafts[sl], d_lens[sl])
            got_map.append(np.asarray(dev_map(*a, S, S, W, 5, -4, -8)))
            runs, n = rs.cigar_runs_device_raw(*a, W, 2, -4, -2, maxr)
            got_runs.append(np.asarray(runs))
            got_n.append(np.asarray(n))
        got_map = np.concatenate(got_map)
        got_runs = np.concatenate(got_runs)
        got_n = np.concatenate(got_n)
        t_dev = time.time() - t0
        n_ref = min(B, 64 if rehearse else CPU_ROWS[S])
        ref = (reads[:n_ref], r_lens[:n_ref], drafts[:n_ref], d_lens[:n_ref])
        with jax.default_device(cpu):
            want_map = np.asarray(ref_map(*ref, S, S, W, 5, -4, -8))
            want_runs, want_n = ref_cig(*ref, S, S, W, 2, -4, -2, maxr)
            want_runs = np.asarray(want_runs).astype(np.uint16)
            want_n = np.asarray(want_n)
        impl = "cuda kernel" if rs.use_kernel(S, S, W) else "xla scan"
        ok_map = np.array_equal(got_map[:n_ref], want_map)
        ok_runs = (np.array_equal(got_runs[:n_ref], want_runs)
                   and np.array_equal(got_n[:n_ref], want_n))
        print(f"[{card}] rowscan S={S} W={W} B={B} ({impl}) vs cpu xla "
              f"on {n_ref} rows: mapping {'==' if ok_map else '!='}, "
              f"cigar runs {'==' if ok_runs else '!='} "
              f"({time.time() - t0:.1f} s, device {t_dev:.1f} s)",
              flush=True)
        _require(ok_map and ok_runs, f"row scan differs at S={S} W={W}")
        _require((got_n[: B - 8] > 0).all(), f"empty run lists at S={S}")


def phase_golden(card: str):
    """Device consensus on tests/golden/input == the committed goldens."""
    import gzip

    from haslr_tpu.assemble.pipeline import run_assembler
    from haslr_tpu.config import AssembleConfig
    from haslr_tpu.testutil.evaluate import differing_files

    in_dir = os.path.join(HERE, "tests", "golden", "input")
    exp_dir = os.path.join(HERE, "tests", "golden", "expected")
    with tempfile.TemporaryDirectory(prefix="haslr_golden_") as tmp:
        paths = {}
        for name in ("contigs.fa", "lr.fa", "map.paf"):
            paths[name] = os.path.join(tmp, name)
            with gzip.open(os.path.join(in_dir, name + ".gz"), "rb") as fi, \
                    open(paths[name], "wb") as fo:
                fo.write(fi.read())
        out = os.path.join(tmp, "asm")
        run_assembler(
            paths["contigs.fa"], paths["lr.fa"], paths["map.paf"], out,
            cfg=AssembleConfig(consensus_engine="device"), log=None,
        )
        bad = differing_files(exp_dir, out, ["asm.final.fa", "asm.final.ann"],
                              want_prefix="device.")
    print(f"[{card}] golden device consensus: "
          f"{'identical' if not bad else 'DIFFERS ' + str(bad)}", flush=True)
    _require(not bad, f"golden consensus differs: {bad}")


def _run_cli(out, genome_len, lr, sr, devices, platform, threads):
    from haslr_tpu.cli import haslr as cli

    t0 = time.time()
    rc = cli.main([
        "-o", out, "-g", f"{genome_len / 1e6:g}m", "-l", lr, "-x", "pacbio", "-s", sr,
        "-t", str(threads), "--minia-kmer", "49", "--cov-lr", "25",
        "--platform", platform, "--devices", str(devices),
    ])
    _require(rc == 0, f"pipeline failed rc={rc}")
    return time.time() - t0, dict(cli.STAGE_TIMES)


def _dataset(tmp, genome_len):
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from bench_e2e import build_dataset

    t0 = time.time()
    paths = build_dataset(os.path.join(tmp, "data"), genome_len)
    print(f"simulated {genome_len} bp dataset in {time.time() - t0:.1f} s",
          flush=True)
    return paths


def _bucket_memory(jax):
    """memory_analysis() of the fused consensus program for one dispatch
    of an S = 512 bucket of 13-read windows (the bench.py workload): the
    engine splits a bucket into dispatches of at most max_batch reads."""
    import jax.numpy as jnp

    from haslr_tpu.kernels import consensus_dense as cd
    from haslr_tpu.kernels import nw

    S = 512
    W = cd._band_width(S)
    B = cd._pad_batch(cd.max_batch(S, W))
    N = cd._pad_shape(B // 13, 8)
    flat = jax.ShapeDtypeStruct(((N + B) * 300 // 4,), jnp.uint8)
    meta = jax.ShapeDtypeStruct((3 * B + 2 * N,), jnp.int32)
    compiled = cd._dense_rounds_fused.lower(
        flat, meta, N, S, W, 2, 5, -4, -8, cd.VOTE_IMPL,
        nw._resolve_engine(None),
    ).compile()
    return (N, B, S), compiled.memory_analysis()


def phase_e2e(jax, card: str, rehearse: bool, genome_len: int):
    from haslr_tpu.aligner import map as amap
    from haslr_tpu.core import io as cio
    from haslr_tpu.kernels import consensus_dense as cd
    from haslr_tpu.testutil import evaluate

    threads = os.cpu_count() or 1
    tmp = tempfile.mkdtemp(prefix="haslr_smoke_")
    try:
        g_path, sr, lr = _dataset(tmp, genome_len)
        out = os.path.join(tmp, "out")
        cd.PROF.clear()
        wall, stages = _run_cli(out, genome_len, lr, sr, 1,
                                "cpu" if rehearse else "gpu", threads)
        recs = list(cio.read_fastx(glob.glob(f"{out}/asm_*/asm.final.fa")[0]))
        with open(g_path) as f:
            genome = f.read().strip()
        lens = [len(r.seq) for r in recs]
        n50 = evaluate.ng50(lens, len(genome))
        recall = evaluate.interior_kmer_recall(genome, [r.seq for r in recs])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ext = {k: round(v, 2) for k, v in amap.PROF.items()
           if k.startswith("extend")}
    cons = {k: round(v, 2) for k, v in cd.PROF.items()
            if k in ("pack", "unpack", "n_dispatch")}
    cons["device"] = round(sum(v for k, v in cd.PROF.items()
                               if k.startswith("device_")), 2)
    print(f"[{card}] e2e {genome_len} bp, -t {threads}: wall {wall:.1f} s; "
          f"stages {json.dumps({k: round(v, 1) for k, v in stages.items()})}")
    print(f"[{card}] e2e extension phases: {json.dumps(ext)}")
    print(f"[{card}] e2e consensus phases: {json.dumps(cons)}")
    print(f"[{card}] e2e result: {len(recs)} contigs, {sum(lens)} bp, "
          f"NG50 {n50}, interior 31-mer recall {recall:.5f}", flush=True)
    if not rehearse:
        (N, B, S), mem = _bucket_memory(jax)
        print(f"[{card}] consensus dispatch N={N} B={B} S={S} "
              f"memory_analysis: argument {mem.argument_size_in_bytes} B, "
              f"output {mem.output_size_in_bytes} B, "
              f"temp {mem.temp_size_in_bytes} B, "
              f"code {mem.generated_code_size_in_bytes} B")
        peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
        print(f"[{card}] peak_bytes_in_use after the e2e run: {peak}",
              flush=True)
    _require(n50 >= NG50_MIN_FRACTION * genome_len, f"NG50 {n50}")
    _require(recall >= RECALL_MIN, f"recall {recall}")


def four_devices(jax, card: str, n_dev: int, genome_len: int,
                 platform: str):
    """The 4.6 Mb CLI with --devices n and --devices 1: the PAF and
    asm.final.fa must be byte-identical."""
    threads = os.cpu_count() or 1
    tmp = tempfile.mkdtemp(prefix="haslr_smoke_")
    try:
        _g, sr, lr = _dataset(tmp, genome_len)
        outs = {}
        for d in (n_dev, 1):
            out = os.path.join(tmp, f"out{d}")
            wall, stages = _run_cli(out, genome_len, lr, sr, d, platform,
                                    threads)
            print(f"[{card}] e2e --devices {d}: wall {wall:.1f} s; stages "
                  f"{json.dumps({k: round(v, 1) for k, v in stages.items()})}",
                  flush=True)
            outs[d] = out
        same = {}
        for pat in ("map_*.paf", "asm_*/asm.final.fa"):
            blobs = []
            for d in (n_dev, 1):
                (path,) = glob.glob(os.path.join(outs[d], pat))
                with open(path, "rb") as f:
                    blobs.append(f.read())
            same[pat] = blobs[0] == blobs[1] and len(blobs[0]) > 0
            print(f"[{card}] {pat}: --devices {n_dev} vs 1 "
                  f"{'byte-identical' if same[pat] else 'DIFFER'} "
                  f"({len(blobs[0])} / {len(blobs[1])} bytes)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _require(all(same.values()), f"--devices outputs differ: {same}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the --devices 4 vs 1 comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at a small size (no device result)")
    a = ap.parse_args()
    genome_len = 150_000 if a.rehearse else GENOME_LEN
    t0 = time.time()
    jax = _start_jax(a.rehearse, a.devices)
    card = phase_env(jax, a.rehearse)
    if a.devices > 1:
        _require(len(jax.devices()) >= a.devices,
                 f"{a.devices} devices asked, {jax.devices()} found")
        four_devices(jax, card, a.devices, genome_len,
                     "cpu" if a.rehearse else "gpu")
    else:
        # (c) first: the peak device memory it prints is then its own
        phase_e2e(jax, card, a.rehearse, genome_len)
        phase_kernels(jax, card, a.rehearse)
        phase_golden(card)
    print(f"all phases passed in {time.time() - t0:.1f} s", flush=True)
    d = jax.devices()
    if a.rehearse:
        print("rehearsal ok on the CPU: no device result")
        return
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d),
    }}))


if __name__ == "__main__":
    main()
