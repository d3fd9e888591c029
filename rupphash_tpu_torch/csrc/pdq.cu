// K1: fused PDQ hashing, one thread block per image.
//
// Replaces rupphash_tpu/ops/pdq_pallas.py::_pdq_kernel (the fused
// Pallas hasher; the JAX package hashes with XLA pdq_jax.pdq_core
// instead).  Per image:
//
//   u8 luma X (hp, wp) -> f32
//   XR      = X . R^T                    (hp, 64)   stage A
//   buf64   = L . XR                     (64, 64)   stage B
//   quality = min(sum trunc(|d| * 100 / 255) / 90, 1) over neighbours
//   coeffs  = D16 . buf64 . D16^T        (16, 16)
//   4 sign patterns -> lower median (128th smallest) by rank counting
//   -> bits -> 8 dihedral variants packed as bytes (byte 31 - idx/8,
//   bit idx%8; transposed variants read bit c*16+r for output r*16+c).
//
// Mixed working shapes share one launch: planes are zero-padded to
// (hp, wp) and each image picks its operators by shape_idx from
// l_unique (S, 64, hp) / r_unique (S, 64, wp), whose padded columns are
// zero.  Every sum runs sequentially from index 0 upwards, so the
// padded zero terms come last and leave the result bit-identical to
// the tight shape.
//
// What bounds it on this card: stages A and B are 64 * wp * (hp + 64)
// fp32 FMAs per image (about 11.5 M at 512x288); everything after them
// is a few hundred thousand operations.  The GEMMs are plain fp32
// CUDA-core FMA from 64x32 tiles in shared memory, 4x4 outputs per
// thread, which leaves them bounded by shared-memory loads (two loads
// per FMA pair).  Exactness matters more than speed here: the hash
// bits and the quality must match the plain PyTorch version, so the
// kernel uses IEEE division, no fast math, and no tensor-core
// (TF32/bf16) arithmetic.  The tensor-core route is later work.
//
// Static shared memory: 3 regions of 64x68 / 32x68 floats (~44 KB),
// reused by the later stages.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // buffer64 side and the X row block
constexpr int kChunk = 32;         // reduction depth staged per step
constexpr int kPad = kTile + 4;    // row pitch of the staged tiles

__device__ __forceinline__ int quality_term(float a, float b) {
  const float d = __fsub_rn(a, b);
  return static_cast<int>(truncf(fabsf(__fdiv_rn(__fmul_rn(d, 100.0f), 255.0f))));
}

__global__ void __launch_bounds__(kThreads)
pdq_hash_kernel(const uint8_t* __restrict__ lumas, int hp, int wp,
                const float* __restrict__ l_unique,
                const float* __restrict__ r_unique,
                const int32_t* __restrict__ shape_idx,
                const float* __restrict__ d16,
                uint8_t* __restrict__ dihedral,
                float* __restrict__ quality,
                float* __restrict__ coeffs) {
  __shared__ __align__(16) float s_a[kChunk * kPad];   // X chunk; later D16-pass scratch
  __shared__ __align__(16) float s_b[kChunk * kPad];   // R / L chunk; later signed coeffs
  __shared__ __align__(16) float s_xr[kTile * kPad];   // XR row block; later buffer64
  __shared__ float s_med[4];
  __shared__ int s_qsum;
  __shared__ uint8_t s_bits[4 * 256];

  const int t = threadIdx.x;
  const int ty = t >> 4;   // 16 x 16 threads, each a 4 x 4 output tile
  const int tx = t & 15;
  const int img = blockIdx.x;
  const uint8_t* x = lumas + static_cast<size_t>(img) * hp * wp;
  const int s = shape_idx[img];
  const float* lop = l_unique + static_cast<size_t>(s) * kTile * hp;
  const float* rop = r_unique + static_cast<size_t>(s) * kTile * wp;

  if (t == 0) s_qsum = 0;

  float acc_b[4][4] = {};   // buffer64[ty*4+i][tx*4+j]
  for (int h0 = 0; h0 < hp; h0 += kTile) {
    // Stage A: XR[hh][p] = sum_w X[h0+hh][w] * R[p][w]
    float acc_a[4][4] = {};
    for (int w0 = 0; w0 < wp; w0 += kChunk) {
      for (int e = t; e < kTile * kChunk; e += kThreads) {
        const int r = e / kChunk;
        const int k = e % kChunk;
        const int h = h0 + r;
        const int w = w0 + k;
        s_a[k * kPad + r] =
            (h < hp && w < wp) ? static_cast<float>(x[static_cast<size_t>(h) * wp + w]) : 0.0f;
        s_b[k * kPad + r] = (w < wp) ? rop[static_cast<size_t>(r) * wp + w] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = s_a[k * kPad + ty * 4 + i];
          b[i] = s_b[k * kPad + tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_a[i][j] = fmaf(a[i], b[j], acc_a[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_xr[(ty * 4 + i) * kPad + tx * 4 + j] = acc_a[i][j];

    // Stage B: buffer64[p][q] += sum_hh L[p][h0+hh] * XR[hh][q]
    for (int k0 = 0; k0 < kTile; k0 += kChunk) {
      for (int e = t; e < kTile * kChunk; e += kThreads) {
        const int p = e / kChunk;
        const int k = e % kChunk;
        const int h = h0 + k0 + k;
        s_b[k * kPad + p] = (h < hp) ? lop[static_cast<size_t>(p) * hp + h] : 0.0f;
      }
      __syncthreads();   // also publishes s_xr
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = s_b[k * kPad + ty * 4 + i];
          b[i] = s_xr[(k0 + k) * kPad + tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_b[i][j] = fmaf(a[i], b[j], acc_b[i][j]);
      }
      __syncthreads();
    }
  }

  float* buf = s_xr;   // buffer64, row pitch kPad
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) buf[(ty * 4 + i) * kPad + tx * 4 + j] = acc_b[i][j];
  __syncthreads();

  // Quality: every term is a small integer, so the sum is exact in any order.
  int qs = 0;
  for (int e = t; e < (kTile - 1) * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;   // vertical neighbours
    qs += quality_term(buf[r * kPad + c], buf[(r + 1) * kPad + c]);
    const int r2 = e / (kTile - 1), c2 = e % (kTile - 1);   // horizontal
    qs += quality_term(buf[r2 * kPad + c2], buf[r2 * kPad + c2 + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qs += __shfl_down_sync(0xffffffffu, qs, off);
  if ((t & 31) == 0) atomicAdd(&s_qsum, qs);

  // bd[p][c] = sum_q buffer64[p][q] * D16[c][q]   (64 x 16, in s_a)
  float* bd = s_a;
  for (int e = t; e < kTile * 16; e += kThreads) {
    const int p = e / 16, c = e % 16;
    float acc = 0.0f;
    for (int q = 0; q < kTile; ++q) acc = fmaf(buf[p * kPad + q], d16[c * kTile + q], acc);
    bd[e] = acc;
  }
  __syncthreads();
  if (t == 0) {
    quality[img] = fminf(__fdiv_rn(static_cast<float>(s_qsum), 90.0f), 1.0f);
  }

  // coeffs[r][c] = sum_p D16[r][p] * bd[p][c]; thread t owns idx r*16+c.
  const int r = t >> 4, c = t & 15;
  float cf = 0.0f;
  for (int p = 0; p < kTile; ++p) cf = fmaf(d16[r * kTile + p], bd[p * 16 + c], cf);
  coeffs[static_cast<size_t>(img) * 256 + t] = cf;

  // Sign variants [identity, neg cols, neg rows, neg both]: a mirror
  // negates odd DCT frequencies (index + 1), i.e. even indices.
  float* sv = s_b;
  const bool fr = (r & 1) == 0, fc = (c & 1) == 0;
  sv[0 * 256 + t] = cf;
  sv[1 * 256 + t] = fc ? -cf : cf;
  sv[2 * 256 + t] = fr ? -cf : cf;
  sv[3 * 256 + t] = (fr != fc) ? -cf : cf;
  __syncthreads();

  // Lower median by rank counting: the value with #{<} <= 127 < #{<=}.
  // Tied threads write equal values; a +0/-0 tie gives the same bits.
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float xv = sv[v * 256 + t];
    int lt = 0, le = 0;
    for (int j = 0; j < 256; ++j) {
      const float y = sv[v * 256 + j];
      lt += y < xv;
      le += y <= xv;
    }
    if (lt <= 127 && le >= 128) s_med[v] = xv;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < 4; ++v) s_bits[v * 256 + t] = sv[v * 256 + t] > s_med[v];
  __syncthreads();

  // Dihedral order (sign pattern, transposed): identity, rot90, rot180,
  // rot270, mirror-x, mirror-y, transpose, anti-transpose.
  const int kSign[8] = {0, 2, 3, 1, 1, 2, 0, 3};
  const bool kTrans[8] = {false, true, false, true, false, false, true, true};
  const int v = t >> 5, ob = t & 31;
  const int sgn = kSign[v];
  const bool tr = kTrans[v];
  const int base = 8 * (31 - ob);
  unsigned byte = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = base + j;
    const int src = tr ? ((o & 15) * 16 + (o >> 4)) : o;
    byte |= static_cast<unsigned>(s_bits[sgn * 256 + src]) << j;
  }
  dihedral[(static_cast<size_t>(img) * 8 + v) * 32 + ob] = static_cast<uint8_t>(byte);
}

}  // namespace

extern "C" int rupp_pdq_hash(const void* lumas, int b, int hp, int wp,
                             const void* l_unique, const void* r_unique,
                             const void* shape_idx, const void* d16,
                             void* dihedral, void* quality, void* coeffs,
                             void* stream) {
  if (b > 0) {
    pdq_hash_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lumas), hp, wp,
        static_cast<const float*>(l_unique), static_cast<const float*>(r_unique),
        static_cast<const int32_t*>(shape_idx), static_cast<const float*>(d16),
        static_cast<uint8_t*>(dihedral), static_cast<float*>(quality),
        static_cast<float*>(coeffs));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rupp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
