// Probe: the rate of the 1-bit tensor-core MMA (m16n8k256, xor.popc)
// against the int8 mma.sync (m16n8k32) on this card, both from registers
// in the same loop: bit pairs (or int8 products) per second.  A Hamming
// distance needs one bit pair where the +/-1 int8 dot of K3 and K4
// (../hamming.cu) needs one product, so the ratio says what a 1-bit
// route could gain.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o b1_rate_probe b1_rate_probe.cu
//   ./b1_rate_probe
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
constexpr int kIters = 4096, kChains = 8;
__global__ void b1_loop(int* out, uint32_t seed) {
  uint32_t a[4] = {seed ^ threadIdx.x, seed * 3u, seed + 7u, ~seed}, b[2] = {seed * 5u, seed ^ 0x55555555u};
  int c[kChains][4] = {};
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int s = 0;
  for (int k = 0; k < kChains; ++k) for (int i = 0; i < 4; ++i) s += c[k][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void s8_loop(int* out, uint32_t seed) {
  uint32_t a[4] = {seed ^ threadIdx.x, seed * 3u, seed + 7u, ~seed}, b[2] = {seed * 5u, seed ^ 0x55555555u};
  int c[kChains][4] = {};
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int s = 0;
  for (int k = 0; k < kChains; ++k) for (int i = 0; i < 4; ++i) s += c[k][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <class K> float run(K kern, int blocks, int threads, int* out) {
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  kern<<<blocks, threads>>>(out, 12345u); cudaDeviceSynchronize();
  cudaEventRecord(e0);
  for (int r = 0; r < 5; ++r) kern<<<blocks, threads>>>(out, 12345u + r);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1); return ms / 5;
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* out; cudaMalloc(&out, sizeof(int) * sms * 8 * 512);
  for (int threads : {128, 256, 512}) {
    int blocks = sms * 2; double warps = double(blocks) * threads / 32;
    float tb = run(b1_loop, blocks, threads, out), ts = run(s8_loop, blocks, threads, out);
    double pairs_b1 = warps * kIters * kChains * 16.0 * 8 * 256, pairs_s8 = warps * kIters * kChains * 16.0 * 8 * 32;
    printf("B1PROBE threads=%d: b1 m16n8k256 %.3f ms = %.3e bit pairs/s; s8 m16n8k32 %.3f ms = %.3e products/s (%.0f TOP/s); b1/s8 pair rate %.2f; cuda=%d\n",
           threads, tb, pairs_b1 / tb * 1e3, ts, pairs_s8 / ts * 1e3, 2 * pairs_s8 / ts * 1e3 / 1e12, (pairs_b1 / tb) / (pairs_s8 / ts), (int)cudaGetLastError());
  }
  return 0;
}
