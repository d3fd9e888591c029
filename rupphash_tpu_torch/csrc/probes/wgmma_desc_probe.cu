// Probe: which leading/stride byte offsets of a wgmma shared-memory
// descriptor read an MN-major, 128-byte-swizzled bf16 B tile stored
// [k][n] with n contiguous (k-row r at r * 128 bytes, 16-byte chunk c at
// (c ^ (r & 7)) << 4)?  One m64n64k16 product per setting against a host
// product; err=0 marks the settings that read the tile as stored.
// K2 (../pdq_coeffs.cu) stages its X chunks this way.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o wgmma_desc_probe wgmma_desc_probe.cu
//   ./wgmma_desc_probe
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
__device__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) | ((uint64_t)1 << 62);
}
__global__ void probe(const uint16_t* a, const uint16_t* b, float* out, uint32_t lbo, uint32_t sbo) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = (uint8_t*)(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sa = sm; uint8_t* sb = sm + 8192;
  int t = threadIdx.x;
  for (int e = t; e < 64 * 16; e += 128) { int m = e / 16, k = e % 16;
    *(uint16_t*)(sa + m * 128 + (((k / 8) ^ (m & 7)) << 4) + (k % 8) * 2) = a[m * 16 + k]; }
  for (int e = t; e < 16 * 64; e += 128) { int k = e / 64, n = e % 64;
    *(uint16_t*)(sb + k * 128 + (((n / 8) ^ (k & 7)) << 4) + (n % 8) * 2) = b[k * 64 + n]; }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  uint64_t da = desc((uint32_t)__cvta_generic_to_shared(sa), 1, 64);
  uint64_t db = desc((uint32_t)__cvta_generic_to_shared(sb), lbo, sbo);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]) : "l"(da), "l"(db), "r"(0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int warp = t >> 5, lane = t & 31, r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  for (int i = 0; i < 8; ++i) for (int e = 0; e < 4; ++e)
    out[(r0 + (e >= 2 ? 8 : 0)) * 64 + 8 * i + cq + (e & 1)] = d[4 * i + e];
}
static uint16_t bf(float f) { uint32_t u; memcpy(&u, &f, 4); return u >> 16; }
int main() {
  uint16_t ha[64 * 16], hb[16 * 64]; float fa[64 * 16], fb[16 * 64], ref[64 * 64], got[64 * 64];
  for (int m = 0; m < 64; ++m) for (int k = 0; k < 16; ++k) { fa[m * 16 + k] = (m * 3 + 2 * k) % 7 - 3; ha[m * 16 + k] = bf(fa[m * 16 + k]); }
  for (int k = 0; k < 16; ++k) for (int n = 0; n < 64; ++n) { fb[k * 64 + n] = (5 * k + n * n) % 11 - 5; hb[k * 64 + n] = bf(fb[k * 64 + n]); }
  for (int m = 0; m < 64; ++m) for (int n = 0; n < 64; ++n) { float s = 0; for (int k = 0; k < 16; ++k) s += fa[m * 16 + k] * fb[k * 64 + n]; ref[m * 64 + n] = s; }
  uint16_t *da, *db; float* dout;
  cudaMalloc(&da, sizeof ha); cudaMalloc(&db, sizeof hb); cudaMalloc(&dout, sizeof got);
  cudaMemcpy(da, ha, sizeof ha, cudaMemcpyHostToDevice); cudaMemcpy(db, hb, sizeof hb, cudaMemcpyHostToDevice);
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, 20480);
  uint32_t lbos[] = {1, 8, 64, 128, 512}, sbos[] = {64, 8, 1, 128};
  for (uint32_t l : lbos) for (uint32_t s : sbos) {
    cudaMemset(dout, 0, sizeof got);
    probe<<<1, 128, 20480>>>(da, db, dout, l, s);
    cudaError_t e = cudaDeviceSynchronize();
    cudaMemcpy(got, dout, sizeof got, cudaMemcpyDeviceToHost);
    float err = 0; for (int i = 0; i < 4096; ++i) { float d = got[i] - ref[i]; if (d < 0) d = -d; if (d > err) err = d; }
    printf("PROBE lbo=%u sbo=%u err=%g cuda=%d\n", l, s, err, (int)e);
  }
  return 0;
}
