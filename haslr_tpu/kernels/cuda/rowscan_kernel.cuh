// Row-scan banded NW + traceback for Hopper: one warp per read.
//
// The CUDA twin of the XLA row scan in haslr_tpu/kernels/nw_rowscan.py
// (_rowscan_dirs_inner + _rowscan_mapping_inner / _rowscan_cigar_inner),
// bit-identical to it on every read.  The W = 128 band row lives in
// registers, 4 lanes per thread (lanes 4t .. 4t+3 on thread t):
//
//   tmp[k] = max(diag[k] + sub[k], up[k] + gap)       previous row only
//   H[k]   = gap*k + prefix_max(tmp[k] - gap*k)       left-gap chains
//
// The prefix max is 3 in-thread steps plus a 5-level __shfl_up_sync scan
// over the thread totals.  Directions are stored 2-bit packed in shared
// memory (one byte per thread per row, 32 bytes per row), so the DP never
// writes the (R+1, B, W) direction tensor to device memory.  The
// traceback rereads them row by row in the same kernel: the LEFT-run
// search (rightmost non-LEFT cell at or left of the current column) is
// one __reduce_max_sync over (lane << 2 | dir).
//
// Shared memory per read: 32*R direction bytes + the draft (D+1 bytes,
// sentinel 4 at index D) + the read (R bytes).
#pragma once

#include <cstddef>
#include <cstdint>

namespace haslr {

constexpr int kBand = 128;               // W: band lanes
constexpr int kLanesPerThread = kBand / 32;
constexpr int32_t kNeg = -100000000;     // nw_rowscan.NEG
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr unsigned kFull = 0xffffffffu;

struct RowscanArgs {
  const uint8_t* reads;    // (B, R) base codes, 4 = padding
  const int32_t* r_lens;   // (B,)
  const uint8_t* drafts;   // (B, D)
  const int32_t* d_lens;   // (B,)
  const int32_t* base;     // (R+1,) row_bases(R, D, W)
  int32_t* out;            // mapping (B, R) or CIGAR runs (B, maxr)
  int32_t* n_runs;         // (B,) CIGAR mode only
  int R, D, maxr;
  int32_t match, mismatch, gap;
};

inline size_t rowscan_smem_bytes(int R, int D) {
  return static_cast<size_t>(32) * R + (D + 1) + R;
}

__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) {
  return a > b ? a : b;
}

// kCigar = false: out[b, i] is the mapping of nw.traceback_batch
// (draft column, or -(anchor + 3) for an insertion, -1 past r_len).
// kCigar = true: out[b, :] holds the CIGAR runs in traceback order,
// ((len - 1) << 2) | op, zero past the last run; n_runs[b] is the true
// run count (> maxr means the list overflowed).
template <bool kCigar>
__global__ void __launch_bounds__(32) rowscan_kernel(RowscanArgs a) {
  extern __shared__ uint8_t smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int R = a.R, D = a.D;
  uint8_t* dirs = smem;            // row i (1-based) at (i - 1) * 32
  uint8_t* drf = smem + 32 * R;    // draft codes + sentinel
  uint8_t* rd = drf + D + 1;       // read codes

  const int rl = a.r_lens[b];
  const int dl = a.d_lens[b];
  const uint8_t* rg = a.reads + static_cast<size_t>(b) * R;
  const uint8_t* dg = a.drafts + static_cast<size_t>(b) * D;
  for (int k = t; k < rl; k += 32) rd[k] = rg[k];
  for (int k = t; k < D; k += 32) drf[k] = dg[k];
  if (t == 0) drf[D] = 4;
  __syncwarp();

  const int k0 = t * kLanesPerThread;
  int32_t h[kLanesPerThread];
#pragma unroll
  for (int q = 0; q < kLanesPerThread; ++q) {
    const int k = k0 + q;
    h[q] = k <= dl ? a.gap * k : kNeg;
  }

  // ---- DP: rows 1 .. r_len (rows past r_len are never traced back) ----
  int b_prev = a.base[0];
  for (int i = 1; i <= rl; ++i) {
    const int b_i = a.base[i];
    const int s = b_i - b_prev;  // 0 or 1 (rowscan_supported)
    b_prev = b_i;
    int32_t lo = __shfl_up_sync(kFull, h[kLanesPerThread - 1], 1);
    int32_t hi = __shfl_down_sync(kFull, h[0], 1);
    if (t == 0) lo = kNeg;
    if (t == 31) hi = kNeg;
    // ext[m] = previous row at lane k0 - 1 + m
    const int32_t ext[kLanesPerThread + 2] = {lo, h[0], h[1], h[2], h[3],
                                              hi};
    const int rb = rd[i - 1];
    int32_t cand_d[kLanesPerThread], cand_u[kLanesPerThread];
    int32_t p[kLanesPerThread];
    bool valid[kLanesPerThread];
#pragma unroll
    for (int q = 0; q < kLanesPerThread; ++q) {
      const int32_t up = s ? ext[q + 2] : ext[q + 1];
      const int32_t diag = s ? ext[q + 1] : ext[q];
      const int j = b_i + k0 + q;
      int jj = j - 1;
      jj = jj < 0 ? 0 : (jj > D ? D : jj);
      const int32_t sub = rb == drf[jj] ? a.match : a.mismatch;
      cand_d[q] = diag + sub;
      cand_u[q] = up + a.gap;
      valid[q] = j <= dl;
      const int32_t x =
          (valid[q] ? imax(cand_d[q], cand_u[q]) : kNeg) - a.gap * (k0 + q);
      p[q] = q == 0 ? x : imax(p[q - 1], x);
    }
    // inclusive scan of the thread totals, then shift by one thread
    int32_t v = p[kLanesPerThread - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t n = __shfl_up_sync(kFull, v, off);
      if (t >= off) v = imax(v, n);
    }
    const int32_t before = __shfl_up_sync(kFull, v, 1);
    uint32_t packed = 0;
#pragma unroll
    for (int q = 0; q < kLanesPerThread; ++q) {
      const int32_t pm = t > 0 ? imax(before, p[q]) : p[q];
      const int32_t hq = a.gap * (k0 + q) + pm;
      const uint32_t d =
          hq == cand_d[q] ? kDiag : (hq == cand_u[q] ? kUp : kLeft);
      packed |= d << (2 * q);
      h[q] = valid[q] ? hq : kNeg;
    }
    dirs[(i - 1) * 32 + t] = static_cast<uint8_t>(packed);
  }
  __syncwarp();

  // ---- traceback: one row per step, i == r throughout ----
  int32_t* out;
  if (kCigar) {
    out = a.out + static_cast<size_t>(b) * a.maxr;
    for (int k = t; k < a.maxr; k += 32) out[k] = 0;
  } else {
    out = a.out + static_cast<size_t>(b) * R;
    for (int k = rl + t; k < R; k += 32) out[k] = -1;
  }
  __syncwarp();
  int j = dl;
  int cur_op = -1, cur_len = 0, n = 0;
  for (int r = rl; r >= 1; --r) {
    const int b_r = a.base[r];
    const int lane = j - b_r;
    const bool in_band = lane >= 0 && lane < kBand;
    const int lc = lane < 0 ? 0 : (lane > kBand - 1 ? kBand - 1 : lane);
    const uint32_t packed = dirs[(r - 1) * 32 + t];
    int32_t best = -1;
#pragma unroll
    for (int q = 0; q < kLanesPerThread; ++q) {
      const int k = k0 + q;
      const int32_t d = (packed >> (2 * q)) & 3;
      if (d != kLeft && k <= lc) best = (k << 2) | d;
    }
    const int32_t picked = __reduce_max_sync(kFull, best);
    const bool forced = !in_band || picked < 0;
    const int d = forced ? kUp : (picked & 3);
    const int jp = b_r + (forced ? lane : (picked >> 2));
    if (kCigar) {
      const int len_d = j - jp;
      if (len_d > 0) {
        if (cur_len > 0) {
          if (t == 0 && n < a.maxr) out[n] = ((cur_len - 1) << 2) | cur_op;
          ++n;
        }
        if (t == 0 && n < a.maxr) out[n] = ((len_d - 1) << 2) | kLeft;
        ++n;
        cur_len = 0;
      }
      if (cur_len > 0 && cur_op != d) {
        if (t == 0 && n < a.maxr) out[n] = ((cur_len - 1) << 2) | cur_op;
        ++n;
      }
      cur_len = (cur_len > 0 && cur_op == d) ? cur_len + 1 : 1;
      cur_op = d;
    } else if (t == 0) {
      out[r - 1] = d == kDiag ? jp - 1 : -(jp + 2);
    }
    j = d == kDiag ? jp - 1 : jp;
  }
  if (kCigar) {
    if (cur_len > 0) {
      if (t == 0 && n < a.maxr) out[n] = ((cur_len - 1) << 2) | cur_op;
      ++n;
    }
    if (j > 0) {
      if (t == 0 && n < a.maxr) out[n] = ((j - 1) << 2) | kLeft;
      ++n;
    }
    if (t == 0) a.n_runs[b] = n;
  }
}

}  // namespace haslr
