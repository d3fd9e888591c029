// K5: column restack, (1, rows, S * W) f32 -> (S * rows, W) f32, with
// output block s = input columns [s * W, (s + 1) * W).
//
// Replaces the kernel built in rupphash_tpu/tools/mosaic_repro.py::build,
// the TPU repro of a Mosaic compiler abort on unaligned lane slices
// (W = 288 is not a multiple of 128 lanes).  A CUDA thread addresses
// single floats, so no width is special here: W = 128, 256 and 288 all
// take the same path.
//
// What bounds it on this card: it moves bytes and computes nothing, so
// device-memory bandwidth bounds it at large sizes; at the tool's size
// (64 x 8 x 288 floats, 590 KB) one launch is launch latency.  Each
// thread copies one float, so neighbouring threads read and write
// neighbouring addresses within a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
restack_kernel(const float* __restrict__ x, int rows, int slices, int width,
               float* __restrict__ out) {
  const int64_t total = static_cast<int64_t>(slices) * rows * width;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(e % width);
    const int64_t orow = e / width;                 // s * rows + r
    const int s = static_cast<int>(orow / rows);
    const int r = static_cast<int>(orow % rows);
    out[e] = x[static_cast<int64_t>(r) * slices * width + static_cast<int64_t>(s) * width + c];
  }
}

}  // namespace

extern "C" int rupp_restack(const void* x, int rows, int slices, int width, void* out,
                            void* stream) {
  if (rows < 0 || slices < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(slices) * rows * width;
  if (total > 0) {
    const int64_t want = (total + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 65535 ? want : 65535);
    restack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), rows, slices, width, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
