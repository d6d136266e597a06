"""Benchmark: consensus windows/s/chip (the BASELINE.json headline metric).

Measures the device-resident consensus engine (banded-NW align + pileup
vote, 2 polish rounds on device — the replacement for the reference's
per-window SPOA loop, Assemble.cpp:479-605) on a fixed synthetic
workload: 1024 windows x 13 supporting subsequences x ~300 bp at 6%
error — the shape of an E. coli-scale backbone's edge set batched the way
the production pipeline batches it.

``vs_baseline`` is the speedup over the NATIVE C++ POA engine
(haslr_tpu/native/poa.cpp — SPOA semantics: global alignment 5/-4/-8,
align+add per read, heaviest-bundle consensus; the stand-in for the SSE
SPOA library the reference links) on ONE CPU core.  The baseline rate is
measured on a BASELINE_SUBSET-window subset and extrapolated linearly
(windows are iid draws from the same length/error distribution, so the
per-window cost is uniform).  The reference publishes no per-window
number (BASELINE.json ``published`` is empty).

Timeout-hardened layout (every section is budgeted; a benchmark that
cannot emit its number under a hard timeout is a benchmark that doesn't
exist):

1. the native-POA baseline runs FIRST, synchronously, with the machine
   otherwise idle (it takes well under a second once the lazy native
   build is warm) — measuring it concurrently with the device warm-up
   would understate it and flatter ``vs_baseline``;
2. the HEADLINE JSON LINE IS PRINTED AND FLUSHED immediately after the
   consensus timing — nothing slow runs before it except the baseline
   and the consensus warm-up itself;
3. extras (k-mer counting rates) run only while wall-clock budget
   remains (``BENCH_BUDGET`` seconds, also ``--budget``), each in its own
   try block, and a second ENRICHED line (headline fields + extras) is
   printed at the end.  Either line parses on its own.

Runs on the GPU (``--platform gpu``, the default; a missing card is an
error) or, for a rehearsal, ``--platform cpu``.
"""

import json
import os
import sys
import time

T_START = time.time()
BUDGET = float(os.environ.get("BENCH_BUDGET", "540"))

import numpy as np

import jax

# 4096 windows: the engine splits them into sub-groups dispatched
# asynchronously, so the padded shapes (and compiled programs) are those
# of a 1024-window run while fixed per-call costs amortize 4x — this
# measures steady-state throughput, the regime of a real assembly's edge
# set
N_WINDOWS = 4096
N_SUPPORT = 13
WIN_LEN = 300
ERROR_RATE = 0.06
BASELINE_SUBSET = 48


def _remaining() -> float:
    return BUDGET - (time.time() - T_START)


def make_windows(seed=0, n_windows=N_WINDOWS):
    rng = np.random.default_rng(seed)
    bases = "ACGT"

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < ERROR_RATE / 3:
                continue
            if r < 2 * ERROR_RATE / 3:
                out.append(bases[rng.integers(0, 4)])
            else:
                out.append(ch)
                if r < ERROR_RATE:
                    out.append(bases[rng.integers(0, 4)])
        return "".join(out)

    windows = []
    for _ in range(n_windows):
        L = int(rng.integers(WIN_LEN * 2 // 3, WIN_LEN * 4 // 3))
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(N_SUPPORT)])
    return windows


def _timed(fn):
    t0 = time.time()
    fn()
    return time.time() - t0


def _run_baseline(windows, out):
    """Native C++ POA (SPOA-grade), one CPU core; fills ``out`` dict.
    Runs before any device work so nothing contends with it.

    Also estimates the 64-core-node rate the BASELINE comparator actually
    runs at (``README.md:19`` — SPOA on up to 64 threads): the all-core
    threaded run on this host gives a measured per-core scaling
    efficiency, and ``rate_64core_est = rate_1core * 64 * efficiency``.
    On this 2-core box the efficiency sample is small, so the estimate is
    labeled as such — but it keeps every round's headline comparable to
    the real comparator, not just one idle core."""
    try:
        from haslr_tpu.core import seq as cseq
        from haslr_tpu.native import poa_consensus_native

        code_wins = [
            [cseq.encode(s) for s in w] for w in windows[:BASELINE_SUBSET]
        ]
        poa_consensus_native(code_wins[:2])  # warm (lazy native build)
        t0 = time.time()
        poa_consensus_native(code_wins, n_threads=1)
        out["rate"] = BASELINE_SUBSET / (time.time() - t0)
        n_cores = os.cpu_count() or 1
        if n_cores > 1:
            t0 = time.time()
            poa_consensus_native(code_wins, n_threads=n_cores)
            rate_n = BASELINE_SUBSET / (time.time() - t0)
            eff = min(1.0, rate_n / (out["rate"] * n_cores))
            out["eff_per_core"] = eff
            out["rate_64core_est"] = out["rate"] * 64 * eff
    except Exception as e:  # pragma: no cover - diagnostics only
        out["error"] = repr(e)


def bench_kmer_rate_native(n_reads=320_000, coverage_sim=True):
    """PRODUCTION k-mer counting rate (Mbases/s): the native host
    counter (native/kmer.cpp — the single-host minia replacement the
    pipeline actually uses, bin/haslr.py:180) over a 48 Mbp stream of
    150 bp reads drawn 40x-coverage-style from a 1.2 Mb genome (coverage
    structure matters: the hash table holds the DISTINCT k-mers)."""
    import os

    from haslr_tpu.native import count_kmers_native

    rng = np.random.default_rng(5)
    read_len = 150
    if coverage_sim:
        genome = rng.integers(0, 4, 1_200_000).astype(np.uint8)
        starts = rng.integers(0, len(genome) - read_len, n_reads)
        codes = genome[
            starts[:, None] + np.arange(read_len)[None, :]
        ].reshape(-1)
    else:
        codes = rng.integers(
            0, 4, n_reads * read_len, dtype=np.uint8
        ).reshape(-1)
    offsets = np.arange(n_reads + 1, dtype=np.uint64) * read_len
    count_kmers_native(codes[: 150 * 1000], offsets[:1001], 49, 2)  # warm
    t0 = time.time()
    out = count_kmers_native(
        codes, offsets, 49, 2, n_threads=os.cpu_count() or 1
    )
    dt = time.time() - t0
    assert out is not None and len(out[0]) > 0
    return n_reads * read_len / dt / 1e6


def bench_kmer_rate_multihost(n_reads=320_000, n_shards=8):
    """Multi-host SR counting path (Mbases/s): native host count per
    contiguous read shard at min_count=1 + the native k-way merge (the
    production multi-host story, assemble_sr._count_native_sharded).
    Same workload as :func:`bench_kmer_rate_native`; on this one host
    the shards run SERIALLY, so this is a lower-bound proxy — across
    hosts the shards count in parallel (one per host) and each host
    merges only its prefix range.  The serial min_count=1 counting
    dominates this proxy."""
    import os

    from haslr_tpu.kernels.kmer import merge_kmer_counts
    from haslr_tpu.native import count_kmers_native

    rng = np.random.default_rng(5)
    read_len = 150
    genome = rng.integers(0, 4, 1_200_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    codes = genome[
        starts[:, None] + np.arange(read_len)[None, :]
    ].reshape(-1)
    offsets = np.arange(n_reads + 1, dtype=np.uint64) * read_len
    count_kmers_native(codes[: 150 * 1000], offsets[:1001], 49, 1)  # warm
    t0 = time.time()
    shards = []
    for s in range(n_shards):
        a = s * n_reads // n_shards
        b = (s + 1) * n_reads // n_shards
        o = offsets[a : b + 1] - offsets[a]
        c = codes[offsets[a] : offsets[b]]
        shards.append(
            count_kmers_native(c, o, 49, 1,
                               n_threads=os.cpu_count() or 1)
        )
    out = merge_kmer_counts(shards, 2)
    dt = time.time() - t0
    assert len(out[0]) > 0
    return n_reads * read_len / dt / 1e6


def bench_kmer_rate(n_reads=32_000, n_batches=2):
    """Device k-mer counting rate (Mbases/s) through the streaming
    prefix-partitioned counter (the multi-chip scale path).  Measured
    workload: ``n_batches`` batches of ``n_reads`` x 150 bp (default
    2 x 4.8 = 9.6 Mbp), after one full-size warm-up batch that absorbs
    the per-shape compiles."""
    from haslr_tpu.kernels.kmer_stream import count_kmers_streaming

    rng = np.random.default_rng(5)
    read_len = 150

    def batch():
        return [
            r for r in rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)
        ]

    # warm with a FULL batch: the chunk kernel compiles per padded shape,
    # so a smaller warm-up would leave the measured shape cold
    count_kmers_streaming(iter(batch()), 49, 2)
    reads = [batch() for _ in range(n_batches)]
    total = sum(len(b) * read_len for b in reads)
    t0 = time.time()
    for b in reads:
        count_kmers_streaming(iter(b), 49, 2)
    dt = time.time() - t0
    return total / dt / 1e6


def main():
    global BUDGET
    if "--budget" in sys.argv:
        BUDGET = float(sys.argv[sys.argv.index("--budget") + 1])
    from haslr_tpu import runtime

    platform = "gpu"
    if "--platform" in sys.argv:
        platform = sys.argv[sys.argv.index("--platform") + 1]
    runtime.select_platform(platform)
    runtime.init_compile_cache()

    from haslr_tpu.kernels.consensus import batched_consensus

    windows = make_windows()

    # baseline first, machine otherwise idle: it's sub-second warm, and
    # overlapping it with the device warm-up would understate it
    base: dict = {}
    _run_baseline(windows, base)

    # warm-up: compiles the bucket programs (the persistent compile cache
    # makes this seconds when warm)
    warm_dt = _timed(lambda: batched_consensus(windows))
    # best of 3 timed runs
    from haslr_tpu.kernels.consensus_dense import PROF

    PROF.clear()  # prof_phases_s in the enriched line covers the 3 runs
    dev_dt = min(
        _timed(lambda: batched_consensus(windows)) for _ in range(3)
    )
    dev_rate = N_WINDOWS / dev_dt

    poa_rate = base.get("rate")

    rate64 = base.get("rate_64core_est")
    headline = {
        "metric": "consensus_windows_per_s_chip",
        "value": round(dev_rate, 2),
        "unit": "windows/s",
        "vs_baseline": (
            round(dev_rate / poa_rate, 2) if poa_rate else None
        ),
        "baseline": "native C++ POA (SPOA semantics), 1 CPU core, "
                    f"rate extrapolated from {BASELINE_SUBSET} windows",
        "baseline_windows_per_s": (
            round(poa_rate, 2) if poa_rate else base.get("error")
        ),
        # the BASELINE comparator is a 64-thread node (README.md:19);
        # estimated as rate_1core * 64 * measured per-core efficiency
        # (sampled on this host's few cores — labeled estimate)
        "vs_64core_est": (
            round(dev_rate / rate64, 3) if rate64 else None
        ),
        "baseline_64core_est_windows_per_s": (
            round(rate64, 1) if rate64 else None
        ),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "warmup_s": round(warm_dt, 1),
    }
    # the headline must survive a harness timeout of anything below
    print(json.dumps(headline), flush=True)

    extras = {}
    # production (native host) counter: pure host work, seconds — this
    # is the number the pipeline's assemble_srs stage actually runs at
    if _remaining() > 30:
        try:
            extras["kmer_count_mbases_per_s"] = round(
                bench_kmer_rate_native(), 1
            )
        except Exception:
            extras["kmer_count_mbases_per_s"] = "error"
    else:
        extras["kmer_count_mbases_per_s"] = "skipped (budget)"
    # multi-host path: per-shard native count + prefix-range merge
    if _remaining() > 25:
        try:
            extras["kmer_multihost_mbases_per_s"] = round(
                bench_kmer_rate_multihost(), 1
            )
        except Exception:
            extras["kmer_multihost_mbases_per_s"] = "error"
    else:
        extras["kmer_multihost_mbases_per_s"] = "skipped (budget)"
    # device streaming counter (device-resident path); chunk-shape
    # compiles are the slow part cold
    if _remaining() > 240:
        try:
            extras["kmer_device_mbases_per_s"] = round(bench_kmer_rate(), 1)
        except Exception:
            extras["kmer_device_mbases_per_s"] = "error"
    else:
        extras["kmer_device_mbases_per_s"] = "skipped (budget)"

    from haslr_tpu.kernels.consensus_dense import PROF

    extras["prof_phases_s"] = {k: round(v, 2) for k, v in PROF.items()}

    print(json.dumps({**headline, **extras}), flush=True)


if __name__ == "__main__":
    main()
