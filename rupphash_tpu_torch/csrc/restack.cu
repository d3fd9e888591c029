// K5: column restack, (1, rows, S * W) f32 -> (S * rows, W) f32, with
// output block s = input columns [s * W, (s + 1) * W).
//
// Replaces the kernel built in rupphash_tpu/tools/mosaic_repro.py::build,
// the TPU repro of a Mosaic compiler abort on unaligned lane slices
// (W = 288 is not a multiple of 128 lanes).  No width is special here.
//
// What bounds it on this card: it moves bytes and computes nothing, so
// device-memory bandwidth bounds it at large sizes (75.5 MB each way:
// 0.045 ms at 3.35 TB/s); at the tool's size (64 x 8 x 288 floats, 590
// KB, 0.35 us of bytes) one launch takes longer than the bytes.
//
// What the design does about it: a row of W floats is contiguous on both
// sides (input row r, slice s starts at (r * S + s) * W, output row
// s * rows + r at (s * rows + r) * W), so the restack is a copy of
// S * rows row segments.  One warp copies one output row at a time: one
// 32-bit division a row, none an element.  A lane moves 16 bytes (float4)
// when W is a multiple of 4 and both bases are 16-byte aligned, single
// floats otherwise, and starts the loads of four pieces before their
// stores so that enough bytes are in flight; warps stride over the rows
// when there are more rows than the grid holds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;         // per block
constexpr int kUnroll = 4;        // pieces a lane has in flight
constexpr int kBlocksPerSm = 8;

// T: float4 (pieces of 16 bytes) or float; `width` counts pieces.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
restack_kernel(const T* __restrict__ x, int rows, int slices, int width, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n_rows = slices * rows;
  for (int orow = blockIdx.x * kWarps + (threadIdx.x >> 5); orow < n_rows;
       orow += gridDim.x * kWarps) {
    const int s = orow / rows, r = orow - s * rows;
    const T* src = x + (static_cast<int64_t>(r) * slices + s) * width;
    T* dst = out + static_cast<int64_t>(orow) * width;
    for (int c0 = lane; c0 < width; c0 += 32 * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + 32 * u < width) v[u] = __ldg(src + c0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + 32 * u < width) dst[c0 + 32 * u] = v[u];
    }
  }
}

template <typename T>
void launch(cudaStream_t st, const void* x, int rows, int slices, int width, void* out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (static_cast<int64_t>(slices) * rows + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  restack_kernel<T><<<static_cast<int>(want < most ? want : most), 32 * kWarps, 0, st>>>(
      static_cast<const T*>(x), rows, slices, width, static_cast<T*>(out));
}

}  // namespace

// Output rows are indexed in 32 bits: slices * rows < 2^31.
extern "C" int rupp_restack(const void* x, int rows, int slices, int width, void* out,
                            void* stream) {
  if (rows < 0 || slices < 0 || width < 0 ||
      static_cast<int64_t>(slices) * rows > INT32_MAX - 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(slices) * rows * width > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec)
      launch<float4>(st, x, rows, slices, width / 4, out);
    else
      launch<float>(st, x, rows, slices, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
