// K2: the hybrid PDQ front half, u8 luma -> 16x16 DCT coefficients and
// quality, one thread block per image.
//
// Replaces rupphash_tpu/ops/pdq_pallas.py::_coeffs_kernel (built by
// _build_hybrid, called by pdq_hash_batch_hybrid).  Per image:
//
//   T1      = L1 . X + L2 . X + L3 . X    (64, cols)  bf16 tensor cores
//   buf64   = T1 . R^T                   (64, 64)    fp32 FMA
//   quality = min(sum trunc(|d| * 100 / 255) / 90, 1) over neighbours
//   coeffs  = D16 . buf64 . D16^T        (16, 16)    fp32 FMA
//
// L1 + L2 + L3 is the float32 operator L split into three bf16 terms
// (_split3); the luma X is exact in bf16 (integers 0..255), and every
// bf16 x bf16 product is exact in fp32, so the three products together
// carry L's full mantissa.  The median, the dihedral variants and the
// packing stay in PyTorch (pdq_torch.dihedral_from_coeffs), as the
// reference pairs this kernel with pdq_jax.dihedral_from_coeffs.
//
// Exactness: the tensor core's internal sum over an MMA's k = 16 is
// not an IEEE sequential sum.  Each MMA therefore starts from a zero
// accumulator and its result is added into the running fp32 sum with
// an IEEE add, one running sum per split term, and the three are added
// last as (T1_1 + T1_2) + T1_3 as the reference does.  A coefficient
// next to the median would flip a hash bit if T1 drifted further.
//
// What bounds it on this card: stage 1 is 3 * 64 * rows * cols MACs
// (28 M at 512x288) on the tensor cores, stage 2 64 * 64 * cols fp32
// FMAs (2.1 M at cols = 512), the rest a few hundred thousand.  The
// exact-sum rule adds one fp32 add per MMA output, as many adds as
// stage 2 has FMAs, so the kernel is bounded by fp32 issue and by
// shared-memory operand loads, not by the tensor cores.
//
// Layout: one persistent block per SM walks over the batch's images.
// The three L terms (3 x 64 x rows bf16, at most 200 KB at 512 rows)
// are staged into dynamic shared memory once per block; every image
// then stages only its X, 32 columns x 64 rows at a time, converted to
// bf16 and transposed so that a B fragment is one 32-bit load.  Each
// warp owns a 16 x 16 piece of the 64 x 32 T1 block; stage 2 is K1's
// register-tiled FMA over it.  wgmma with TMA is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 64;       // buffer64 side, rows of L
constexpr int kColBlock = 32;   // columns of X per T1 block
constexpr int kRowChunk = 64;   // rows of X staged per step (4 MMA k-steps)
constexpr int kMaxRows = 512;
constexpr int kXPitch = kRowChunk + 8;  // bf16 pitch of staged X^T (36 words = 4 mod 32)
constexpr int kTPitch = kColBlock + 4;  // float pitch of the T1 block
constexpr int kBPitch = kRows + 4;      // float pitch of R^T's block and buffer64

__host__ __device__ constexpr int rows_padded(int rows) { return (rows + 15) / 16 * 16; }
// bf16 pitch of a staged L row: (rows_padded / 2 + 4) words, 4 mod 8,
// so the 8 rows of a fragment load hit disjoint banks
__host__ __device__ constexpr int l_pitch(int rows) { return rows_padded(rows) + 8; }

constexpr size_t smem_bytes(int rows) {
  return size_t{3} * kRows * l_pitch(rows) * 2      // L1..L3
         + size_t{kRows} * kBPitch * 4              // T1 block; buffer64
         + size_t{kColBlock} * kBPitch * 4;         // X^T chunk | R^T block | D16 . buffer64
}

__device__ __forceinline__ int quality_term(float a, float b) {
  const float d = __fsub_rn(a, b);
  return static_cast<int>(truncf(fabsf(__fdiv_rn(__fmul_rn(d, 100.0f), 255.0f))));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads, 1)
pdq_coeffs_kernel(const uint8_t* __restrict__ lumas, int b, int rows, int cols,
                  const uint16_t* __restrict__ l1,   // (64, rows) bf16 bits
                  const uint16_t* __restrict__ l2,
                  const uint16_t* __restrict__ l3,
                  const float* __restrict__ rop,     // (64, cols)
                  const float* __restrict__ d16,     // (16, 64)
                  float* __restrict__ coeffs,        // (B, 256)
                  float* __restrict__ quality) {     // (B,)
  extern __shared__ __align__(16) unsigned char smem[];
  const int rpad = rows_padded(rows), lp = l_pitch(rows);
  uint16_t* s_l = reinterpret_cast<uint16_t*>(smem);                   // [split][m][h]
  float* s_t = reinterpret_cast<float*>(smem + size_t{3} * kRows * lp * 2);
  float* s_u = s_t + kRows * kBPitch;
  uint16_t* s_x = reinterpret_cast<uint16_t*>(s_u);                    // [w][h]
  float* s_r = s_u;                                                    // [w][q]
  __shared__ int s_qsum;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 3;          // m16 tile of T1 rows
  const int nh = warp >> 2;         // half of the column block (2 n8 tiles)
  const int ty = t >> 4, tx = t & 15;  // stage 2: 4 x 4 outputs per thread
  const uint16_t* lsplit[3] = {l1, l2, l3};

  for (int e = t; e < 3 * kRows * rpad; e += kThreads) {
    const int s = e / (kRows * rpad);
    const int m = (e / rpad) % kRows, k = e % rpad;
    s_l[(s * kRows + m) * lp + k] =
        k < rows ? lsplit[s][static_cast<size_t>(m) * rows + k] : static_cast<uint16_t>(0);
  }

  for (int img = blockIdx.x; img < b; img += gridDim.x) {
    const uint8_t* x = lumas + static_cast<size_t>(img) * rows * cols;
    if (t == 0) s_qsum = 0;
    float acc_b[4][4] = {};   // buffer64[ty*4+i][tx*4+j]

    for (int w0 = 0; w0 < cols; w0 += kColBlock) {
      float acc[3][2][4] = {};  // [split][n8 tile][fragment]
      for (int h0 = 0; h0 < rpad; h0 += kRowChunk) {
        __syncthreads();   // the previous users of s_u are done
        for (int e = t; e < kRowChunk * kColBlock; e += kThreads) {
          const int r = e / kColBlock, c = e % kColBlock;
          const int h = h0 + r, w = w0 + c;
          const float v =
              (h < rows && w < cols) ? static_cast<float>(x[static_cast<size_t>(h) * cols + w]) : 0.0f;
          s_x[c * kXPitch + r] = static_cast<uint16_t>(__float_as_uint(v) >> 16);  // exact
        }
        __syncthreads();
        const int ksteps = min(kRowChunk, rpad - h0) / 16;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t bf[2][2];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint16_t* bp = s_x + (nh * 16 + n * 8 + g) * kXPitch + ks * 16 + 2 * tq;
            bf[n][0] = ld32(bp);
            bf[n][1] = ld32(bp + 8);
          }
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const uint16_t* ap = s_l + (s * kRows + mt * 16 + g) * lp + h0 + ks * 16 + 2 * tq;
            const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * lp);
            const uint32_t a2 = ld32(ap + 8), a3 = ld32(ap + 8 * lp + 8);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              float d[4];
              mma_bf16(d, a0, a1, a2, a3, bf[n][0], bf[n][1]);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[s][n][c] = __fadd_rn(acc[s][n][c], d[c]);
            }
          }
        }
      }
      __syncthreads();   // stage 1 is done with s_x; stage 2 of the last block with s_t, s_r
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = mt * 16 + g + (c >= 2 ? 8 : 0);
          const int col = nh * 16 + n * 8 + 2 * tq + (c & 1);
          s_t[m * kTPitch + col] = __fadd_rn(__fadd_rn(acc[0][n][c], acc[1][n][c]), acc[2][n][c]);
        }
      for (int e = t; e < kRows * kColBlock; e += kThreads) {
        const int q = e / kColBlock, w = e % kColBlock;
        s_r[w * kBPitch + q] = (w0 + w < cols) ? rop[static_cast<size_t>(q) * cols + w0 + w] : 0.0f;
      }
      __syncthreads();
      // Stage 2: buffer64[p][q] += sum_w T1[p][w0+w] * R[q][w0+w]
#pragma unroll 4
      for (int w = 0; w < kColBlock; ++w) {
        float a[4], bq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = s_t[(ty * 4 + i) * kTPitch + w];
          bq[i] = s_r[w * kBPitch + tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_b[i][j] = fmaf(a[i], bq[j], acc_b[i][j]);
      }
    }

    __syncthreads();
    float* buf = s_t;   // buffer64, row pitch kBPitch
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[(ty * 4 + i) * kBPitch + tx * 4 + j] = acc_b[i][j];
    __syncthreads();

    // Quality: every term is a small integer, so the sum is exact in any order.
    int qs = 0;
    for (int e = t; e < (kRows - 1) * kRows; e += kThreads) {
      const int r = e / kRows, c = e % kRows;   // vertical neighbours
      qs += quality_term(buf[r * kBPitch + c], buf[(r + 1) * kBPitch + c]);
      const int r2 = e / (kRows - 1), c2 = e % (kRows - 1);   // horizontal
      qs += quality_term(buf[r2 * kBPitch + c2], buf[r2 * kBPitch + c2 + 1]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) qs += __shfl_down_sync(0xffffffffu, qs, off);
    if (lane == 0) atomicAdd(&s_qsum, qs);

    // bd[p][c] = sum_q buffer64[p][q] * D16[c][q]   (64 x 16, in s_u)
    float* bd = s_u;
    for (int e = t; e < kRows * 16; e += kThreads) {
      const int p = e / 16, c = e % 16;
      float a = 0.0f;
      for (int q = 0; q < kRows; ++q) a = fmaf(buf[p * kBPitch + q], d16[c * kRows + q], a);
      bd[e] = a;
    }
    __syncthreads();
    if (t == 0) quality[img] = fminf(__fdiv_rn(static_cast<float>(s_qsum), 90.0f), 1.0f);

    // coeffs[r][c] = sum_p D16[r][p] * bd[p][c]; thread t owns idx r*16+c.
    const int r = t >> 4, c = t & 15;
    float cf = 0.0f;
    for (int p = 0; p < kRows; ++p) cf = fmaf(d16[r * kRows + p], bd[p * 16 + c], cf);
    coeffs[static_cast<size_t>(img) * 256 + t] = cf;
  }
}

}  // namespace

extern "C" int rupp_pdq_coeffs(const void* lumas, int b, int rows, int cols, const void* l1,
                               const void* l2, const void* l3, const void* r_op,
                               const void* d16, void* coeffs, void* quality, void* stream) {
  if (rows < 1 || rows > kMaxRows || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(rows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pdq_coeffs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = b < sms ? b : sms;
  pdq_coeffs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lumas), b, rows, cols, static_cast<const uint16_t*>(l1),
      static_cast<const uint16_t*>(l2), static_cast<const uint16_t*>(l3),
      static_cast<const float*>(r_op), static_cast<const float*>(d16),
      static_cast<float*>(coeffs), static_cast<float*>(quality));
  return static_cast<int>(cudaGetLastError());
}
