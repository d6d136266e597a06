"""The row-scan DP as a CUDA kernel for Hopper, called through ``jax.ffi``.

One warp aligns one read: the W = 128 band row stays in registers and
the direction rows in shared memory, so DP and traceback run in one
launch that reads the reads and drafts once and writes only the mapping
or the CIGAR runs (``cuda/rowscan_kernel.cuh``).  The XLA scan in
:mod:`haslr_tpu.kernels.nw_rowscan` materializes the (R+1, B, W)
direction tensor in device memory and runs each row step as separate
kernels; this kernel replaces it at the shapes of
``nw_rowscan.kernel_applies``.

``libhaslr_rowscan.so`` is built from the committed sources with
``nvcc`` (``sm_90a``) at first use into ``cuda/build/`` and rebuilt when
a source is newer.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SOURCES = (
    os.path.join(_DIR, "rowscan.cu"),
    os.path.join(_DIR, "rowscan_kernel.cuh"),
)
_SO = os.path.join(_DIR, "build", "libhaslr_rowscan.so")
_MAPPING = "haslr_rowscan_mapping"
_CIGAR = "haslr_rowscan_cigar"

_lib = None
# seconds the last nvcc build took in this process (None: not built here)
BUILD_SECONDS: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def build() -> str:
    """Compile the kernel library; returns its path or raises with the
    compiler's output."""
    global BUILD_SECONDS
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SOURCES[0],
    ]
    t0 = time.time()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
    except OSError as e:
        raise RuntimeError(f"cannot run nvcc ({cmd[0]}): {e}") from e
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, _SO)
    BUILD_SECONDS = time.time() - t0
    return _SO


def load():
    """Build if stale, load, and register both FFI targets (once)."""
    global _lib
    if _lib is None:
        newest = max(os.path.getmtime(s) for s in _SOURCES)
        if not os.path.isfile(_SO) or os.path.getmtime(_SO) < newest:
            build()
        lib = ctypes.cdll.LoadLibrary(_SO)
        for name, sym in ((_MAPPING, lib.HaslrRowscanMapping),
                          (_CIGAR, lib.HaslrRowscanCigar)):
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(sym), platform="CUDA"
            )
        _lib = lib
    return _lib


def _operands(reads, r_lens, drafts, d_lens, base):
    r_lens = r_lens.astype(jnp.int32)
    # anchor the constant row bases to a batch input: under shard_map the
    # FFI call needs every operand to vary over the same mesh axes
    base = jnp.asarray(base, jnp.int32) + r_lens[:1] * 0
    return (reads.astype(jnp.uint8), r_lens, drafts.astype(jnp.uint8),
            d_lens.astype(jnp.int32), base)


def _scores(match, mismatch, gap):
    return {"match": np.int32(match), "mismatch": np.int32(mismatch),
            "gap": np.int32(gap)}


def mapping(reads, r_lens, drafts, d_lens, base, match, mismatch, gap):
    """(B, R) int32 mapping; same contract as
    ``nw_rowscan._rowscan_mapping_inner``."""
    load()
    B, R = reads.shape
    return jax.ffi.ffi_call(
        _MAPPING, jax.ShapeDtypeStruct((B, R), jnp.int32)
    )(*_operands(reads, r_lens, drafts, d_lens, base),
      **_scores(match, mismatch, gap))


def cigar(reads, r_lens, drafts, d_lens, base, match, mismatch, gap, maxr):
    """``(runs (B, maxr) int32, n_runs (B,) int32)``; same contract as
    ``nw_rowscan._rowscan_cigar_inner``."""
    load()
    B = reads.shape[0]
    runs, n_runs = jax.ffi.ffi_call(
        _CIGAR,
        (jax.ShapeDtypeStruct((B, maxr), jnp.int32),
         jax.ShapeDtypeStruct((B,), jnp.int32)),
    )(*_operands(reads, r_lens, drafts, d_lens, base),
      **_scores(match, mismatch, gap))
    return runs, n_runs
