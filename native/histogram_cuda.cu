// Split-statistics histogram pass for NVIDIA Hopper, called from JAX
// through the XLA foreign function interface (ops/cuda_histogram.py).
//
// Contract (the plain-XLA reference is ops/histogram.py::histogram_pass_xla):
//
//   out[i, f, b, c] = sum over docs n with pos[n] == n0 + i and
//                     binned[n, f] == b of values[n, c]
//
// for i in [0, k), f in [0, F), b in [0, num_bins), c in [0, C).  Bin ids
// outside [0, num_bins) and docs whose node is outside [n0, n0 + k) add
// nothing.  ``values`` is doc-major [N, C] f32, already zero for docs
// outside the doc mask.
//
// Design: one block takes a group of G features and a contiguous chunk of
// docs.  Thread (row, lane) reads binned[n, g0 + lane] for docs n = row,
// row + rows, ... of the chunk, so a warp reads contiguous bytes of one
// doc row, and the lanes of a warp hit different features: no two lanes
// add to the same shared-memory word, however skewed the bins are.  The
// block keeps [G, num_bins, k, C] partial sums in shared memory (per
// feature a stride of odd length, so equal bins of neighbouring features
// fall in different banks) and adds them to the output once per bin with
// global atomics.  Zero values are skipped: adding +0.0 changes no sum.
//
// Float atomics add in an order that changes from run to run, so the
// gradient sums may differ in the last bits between two runs; the count
// channel holds integers below 2^24 and is exact.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 512;
// Shared memory per block: 96 KiB leaves room for two blocks per SM.
constexpr int kSmemFloats = 24 * 1024;

template <typename BinT>
__global__ void NodeHistogramKernel(const BinT* __restrict__ binned,
                                    const float* __restrict__ values,
                                    const int32_t* __restrict__ pos,
                                    float* __restrict__ out, int64_t n_docs,
                                    int num_features, int num_channels,
                                    int num_bins, int n0, int k, int group,
                                    int stride, int64_t docs_per_block) {
  extern __shared__ float smem[];
  const int g0 = blockIdx.x * group;
  const int g_here = min(group, num_features - g0);
  const int cell = k * num_channels;  // floats per (feature, bin)

  for (int i = threadIdx.x; i < group * stride; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x % group;
  const int row = threadIdx.x / group;
  const int rows = blockDim.x / group;
  const int64_t start = blockIdx.y * docs_per_block;
  const int64_t end = min(n_docs, start + docs_per_block);
  if (row < rows && lane < g_here) {
    float* my = smem + lane * stride;
    for (int64_t n = start + row; n < end; n += rows) {
      const int node = pos[n] - n0;
      if (node < 0 || node >= k) continue;
      const int b = static_cast<int>(binned[n * num_features + g0 + lane]);
      if (b < 0 || b >= num_bins) continue;
      float* dst = my + b * cell + node * num_channels;
      const float* v = values + n * num_channels;
      for (int c = 0; c < num_channels; ++c) {
        const float x = v[c];
        if (x != 0.f) atomicAdd(dst + c, x);
      }
    }
  }
  __syncthreads();

  // flush: shared [g][b][node][c] -> out [node][f][b][c]
  const int per_feature = num_bins * cell;
  for (int i = threadIdx.x; i < g_here * per_feature; i += blockDim.x) {
    const int g = i / per_feature;
    const int r = i % per_feature;
    const float x = smem[g * stride + r];
    if (x == 0.f) continue;
    const int b = r / cell;
    const int node = (r % cell) / num_channels;
    const int c = r % num_channels;
    atomicAdd(out + ((static_cast<int64_t>(node) * num_features + g0 + g) *
                         num_bins + b) * num_channels + c,
              x);
  }
}

template <typename BinT>
ffi::Error Launch(cudaStream_t stream, const void* binned, const float* values,
                  const int32_t* pos, float* out, int64_t n_docs,
                  int num_features, int num_channels, int num_bins, int n0,
                  int k) {
  const int cell = k * num_channels;
  // odd per-feature stride: equal bins of neighbouring features land in
  // different shared-memory banks
  const int stride = (num_bins * cell) | 1;
  if (stride > kSmemFloats) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "histogram pass does not fit in shared memory; split "
                      "the nodes into smaller passes");
  }
  // balance the feature groups: the fewest groups that fit, equally wide
  const int max_group = std::min({32, kSmemFloats / stride, num_features});
  const int n_groups = (num_features + max_group - 1) / max_group;
  const int group = (num_features + n_groups - 1) / n_groups;
  const int rows = kThreads / group;

  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // about four blocks per SM in all, each with at least 16 docs per row
  const int64_t want = std::max<int64_t>(1, (4LL * sms + n_groups - 1) / n_groups);
  const int64_t most = std::max<int64_t>(1, n_docs / (16LL * rows));
  const int64_t chunks = std::min(want, most);
  const int64_t docs_per_block = (n_docs + chunks - 1) / chunks;
  const size_t smem_bytes = sizeof(float) * static_cast<size_t>(group) * stride;

  auto kernel = NodeHistogramKernel<BinT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes));
  cudaMemsetAsync(out, 0,
                  sizeof(float) * static_cast<size_t>(k) * num_features *
                      num_bins * num_channels,
                  stream);
  if (n_docs > 0) {
    const dim3 grid(n_groups, static_cast<unsigned>(chunks));
    kernel<<<grid, group * rows, smem_bytes, stream>>>(
        static_cast<const BinT*>(binned), values, pos, out, n_docs,
        num_features, num_channels, num_bins, n0, k, group, stride,
        docs_per_block);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error NodeHistogramImpl(cudaStream_t stream, ffi::AnyBuffer binned,
                             ffi::Buffer<ffi::F32> values,
                             ffi::Buffer<ffi::S32> pos,
                             ffi::ResultBuffer<ffi::F32> out, int32_t n0,
                             int32_t k, int32_t num_bins) {
  const auto bdims = binned.dimensions();
  const auto vdims = values.dimensions();
  if (bdims.size() != 2 || vdims.size() != 2 || vdims[0] != bdims[0] ||
      pos.element_count() != static_cast<size_t>(bdims[0])) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "expected binned [N, F], values [N, C], pos [N]");
  }
  const int64_t n_docs = bdims[0];
  const int num_features = static_cast<int>(bdims[1]);
  const int num_channels = static_cast<int>(vdims[1]);
  const void* b = binned.untyped_data();
  const float* v = values.typed_data();
  const int32_t* p = pos.typed_data();
  float* o = out->typed_data();
  switch (binned.element_type()) {
    case ffi::DataType::U8:
      return Launch<uint8_t>(stream, b, v, p, o, n_docs, num_features,
                             num_channels, num_bins, n0, k);
    case ffi::DataType::U16:
      return Launch<uint16_t>(stream, b, v, p, o, n_docs, num_features,
                              num_channels, num_bins, n0, k);
    case ffi::DataType::S32:
      return Launch<int32_t>(stream, b, v, p, o, n_docs, num_features,
                             num_channels, num_bins, n0, k);
    default:
      return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                        "binned must be uint8, uint16 or int32");
  }
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(QrNodeHistogram, NodeHistogramImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("n0")
                                  .Attr<int32_t>("k")
                                  .Attr<int32_t>("num_bins"));
