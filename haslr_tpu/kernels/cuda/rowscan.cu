// XLA FFI handlers for the row-scan kernel (rowscan_kernel.cuh).
//
// Built by haslr_tpu/kernels/rowscan_gpu.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> rowscan.cu
// Each handler only enqueues one launch (one 32-thread block per read)
// on XLA's stream.

#include <cuda_runtime.h>

#include <string>

#include "rowscan_kernel.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

template <bool kCigar>
ffi::Error Launch(cudaStream_t stream, ffi::Buffer<ffi::U8> reads,
                  ffi::Buffer<ffi::S32> r_lens, ffi::Buffer<ffi::U8> drafts,
                  ffi::Buffer<ffi::S32> d_lens, ffi::Buffer<ffi::S32> base,
                  int32_t* out, int32_t* n_runs, int maxr, int32_t match,
                  int32_t mismatch, int32_t gap) {
  const auto rd = reads.dimensions();
  const auto dd = drafts.dimensions();
  if (rd.size() != 2 || dd.size() != 2 || rd[0] != dd[0]) {
    return ffi::Error::InvalidArgument("rowscan: reads/drafts must be (B, R)/(B, D)");
  }
  const int B = static_cast<int>(rd[0]);
  const int R = static_cast<int>(rd[1]);
  const int D = static_cast<int>(dd[1]);
  if (base.element_count() != static_cast<size_t>(R) + 1) {
    return ffi::Error::InvalidArgument("rowscan: base must have R + 1 entries");
  }
  if (B == 0) return ffi::Error::Success();
  haslr::RowscanArgs a{reads.typed_data(), r_lens.typed_data(),
                       drafts.typed_data(), d_lens.typed_data(),
                       base.typed_data(),   out,
                       n_runs,              R,
                       D,                   maxr,
                       match,               mismatch,
                       gap};
  const size_t smem = haslr::rowscan_smem_bytes(R, D);
  auto kernel = haslr::rowscan_kernel<kCigar>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    kernel<<<B, 32, smem, stream>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("rowscan launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error MappingImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> reads,
                       ffi::Buffer<ffi::S32> r_lens,
                       ffi::Buffer<ffi::U8> drafts,
                       ffi::Buffer<ffi::S32> d_lens,
                       ffi::Buffer<ffi::S32> base,
                       ffi::ResultBuffer<ffi::S32> mapping, int32_t match,
                       int32_t mismatch, int32_t gap) {
  return Launch<false>(stream, reads, r_lens, drafts, d_lens, base,
                       mapping->typed_data(), nullptr, 0, match, mismatch,
                       gap);
}

ffi::Error CigarImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> reads,
                     ffi::Buffer<ffi::S32> r_lens, ffi::Buffer<ffi::U8> drafts,
                     ffi::Buffer<ffi::S32> d_lens, ffi::Buffer<ffi::S32> base,
                     ffi::ResultBuffer<ffi::S32> runs,
                     ffi::ResultBuffer<ffi::S32> n_runs, int32_t match,
                     int32_t mismatch, int32_t gap) {
  const int maxr = static_cast<int>(runs->dimensions()[1]);
  return Launch<true>(stream, reads, r_lens, drafts, d_lens, base,
                      runs->typed_data(), n_runs->typed_data(), maxr, match,
                      mismatch, gap);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(HaslrRowscanMapping, MappingImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(HaslrRowscanCigar, CigarImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap"));
