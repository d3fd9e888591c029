// K2: the hybrid PDQ hasher, u8 luma -> 16x16 DCT coefficients, quality
// and the eight dihedral hashes, one warpgroup per image.
//
// Replaces rupphash_tpu/ops/pdq_pallas.py::_coeffs_kernel (built by
// _build_hybrid, called by pdq_hash_batch_hybrid) together with the
// epilogue the JAX package ran after it (pdq_jax.dihedral_from_coeffs).
// Per image:
//
//   T1      = L1 . X + L2 . X + L3 . X    (64, cols)  bf16 tensor cores
//   buf64   = T1 . R^T                   (64, 64)    fp32 FMA
//   quality, coeffs = D16 . buf64 . D16^T, medians, dihedral hashes:
//   pdq_epilogue.cuh, the code K1 runs after its own buffer64.
//
// L1 + L2 + L3 is the float32 operator L split into three bf16 terms
// (_split3); the luma X is exact in bf16 (integers 0..255), and every
// bf16 x bf16 product is exact in fp32, so the three products together
// carry L's full mantissa.
//
// Exactness, stated once: the tensor core's internal sum over an MMA's
// k = 16 is not an IEEE sequential sum.  Each wgmma therefore covers one
// k16 step of one split term from a zero accumulator (scale-d = 0), and
// its result is added into that term's running fp32 sum with an IEEE
// add in registers, k ascending; the three sums are added last as
// (T1_1 + T1_2) + T1_3, as the reference does.  Stage 2 and the D16
// products are fp32 FMA in index order.  A coefficient next to the
// median would flip a hash bit if T1 drifted further.  Zero padding (k up
// to a multiple of 32, columns up to a multiple of 64) adds exact zeros.
//
// What bounds it on this card: stage 1 is 3 * 64 * rows * cols MACs (28 M
// at 288x512) on the tensor cores plus, for the exact-sum rule, one fp32
// add per MMA output (3 * 64 * cols * rows / 16); stage 2 is 64 * 64 *
// cols fp32 FMAs.  The fp32 pipe carries the adds, stage 2 and the u8 ->
// bf16 conversion, so it, not the tensor cores, sets the time.  The
// design keeps it busy:
//
//   * a block holds the three L terms once, as 64-wide k panels in the
//     128-byte swizzle wgmma reads (K-major A operand), and W warpgroups
//     (2 when the terms leave room, else 1), each hashing its own
//     images on its own: one warpgroup's adds and stage 2 overlap the
//     other's MMAs, 256 images fill 132 SMs in one wave, and after the
//     L terms are staged nothing waits on a block-wide barrier;
//   * X needs no transpose: a chunk of 64 rows x 64 columns is read with
//     16-byte loads (prefetched into registers behind the previous
//     chunk's MMAs), widened u8 -> bf16 with two integer permutes and
//     one add per value, and stored row-major (columns contiguous, the
//     MN-major B operand) into one of two swizzled 8 KB buffers;
//   * per chunk, up to 12 wgmma.m64n64k16 (4 k-steps x 3 terms) run one
//     ahead of the adds, alternating two 32-register result buffers;
//   * R arrives transposed ((cols, 64), the wrapper's one small copy), so
//     its 64-column block is 16 KB in a row: 16-byte cp.async behind
//     stage 1 into a swizzled [w][q] tile (conflict-free for the copies
//     and for stage 2's reads); L's terms are staged by cp.async too;
//     T1 goes to shared memory transposed, so
//     a stage-2 thread reads its 4 rows and 8 columns in three 16-byte
//     loads per w and runs 32 FMAs;
//   * d16 and the epilogue's scratch live in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdq_epilogue.cuh"

namespace {

constexpr int kWG = 128;          // one warpgroup hashes one image
constexpr int kRows = pdq_epilogue::kTile;   // buffer64 side, rows of L
constexpr int kNBlk = 64;         // columns of X per block (wgmma N)
constexpr int kKChunk = 64;       // rows of X per chunk: one k panel of L
constexpr int kMaxRows = 512;
constexpr int kPanel = 64 * 128;  // bytes: 64 rows of 64 bf16, one swizzle span each
constexpr int kTPitch = pdq_epilogue::kPad;  // float pitch of T1^T's block and buffer64
constexpr int kSmemLimit = 232448;

// Per warpgroup: T1^T block / buffer64, which the two X buffers share
// (stage 1 is over when T1 is written), then R^T's block, which the
// epilogue's scratch shares.
constexpr int kTBytes = kRows * kTPitch * 4;
constexpr int kRBytes = kNBlk * kRows * 4;
constexpr int kWorkerBytes = kTBytes + kRBytes;
static_assert(2 * kPanel <= kTBytes && pdq_epilogue::kScratchBytes <= kRBytes, "aliases fit");
static_assert(kWorkerBytes % 1024 == 0, "X buffers stay 1024-byte aligned");

__host__ __device__ constexpr int panels(int rows) { return (rows + kKChunk - 1) / kKChunk; }
constexpr int smem_bytes(int rows, int workers) {
  return 1024 /* alignment slack */ + 3 * panels(rows) * kPanel + workers * kWorkerBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptors, 128-byte swizzle.  A (L): K-major,
// 8-row groups 1024 bytes apart.  B (X): MN-major, one 64-column span,
// 8-k groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16 bf16, K-major) . B (16 x 64 bf16, MN-major), from zero.
__device__ __forceinline__ void wgmma_fresh(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void add_into(float (&run)[32], float (&d)[32]) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = __fadd_rn(run[i], d[i]);
}

__device__ __forceinline__ void bar_sync_group(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kWG) : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Bytes lo and lo + 1 of `word` as two bf16 (exact): 0x4B000000 | b is
// the float 2^23 + b, and subtracting 2^23 leaves b.
template <int LO>
__device__ __forceinline__ uint32_t bf16x2(uint32_t word) {
  const float a = __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | LO)),
                            8388608.0f);
  const float b = __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | (LO + 1))),
                            8388608.0f);
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 16 pixels of row h from column w on, zeros outside the image.
__device__ __forceinline__ uint4 load_piece(const uint8_t* __restrict__ x, int h, int w, int rows,
                                            int cols, bool vec) {
  if (h >= rows || w >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* p = x + static_cast<size_t>(h) * cols + w;
  if (vec && w + 16 <= cols) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  const int n = min(16, cols - w);
  for (int i = 0; i < n; ++i) v[i >> 2] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The piece as 16 bf16 into row kk of a swizzled X buffer: columns
// 16 m .. 16 m + 15 are the 16-byte chunks 2 m and 2 m + 1 of the row.
__device__ __forceinline__ void store_piece(uint8_t* xb, int kk, int m, const uint4& v) {
  uint8_t* row = xb + kk * 128;
  const int sw = kk & 7;
  *reinterpret_cast<uint4*>(row + (((2 * m) ^ sw) << 4)) =
      make_uint4(bf16x2<0>(v.x), bf16x2<2>(v.x), bf16x2<0>(v.y), bf16x2<2>(v.y));
  *reinterpret_cast<uint4*>(row + (((2 * m + 1) ^ sw) << 4)) =
      make_uint4(bf16x2<0>(v.z), bf16x2<2>(v.z), bf16x2<0>(v.w), bf16x2<2>(v.w));
}

template <int W>   // warpgroups per block
__global__ void __launch_bounds__(kWG* W, 1)
pdq_coeffs_kernel(const uint8_t* __restrict__ lumas, int b, int rows, int cols,
                  const uint16_t* __restrict__ l1,   // (64, rows) bf16 bits
                  const uint16_t* __restrict__ l2,
                  const uint16_t* __restrict__ l3,
                  const float* __restrict__ rt,      // (cols, 64): R^T
                  const float* __restrict__ d16,     // (16, 64)
                  float* __restrict__ coeffs,        // (B, 256)
                  float* __restrict__ quality,       // (B,)
                  uint8_t* __restrict__ dihedral) {  // (B, 8, 32) or null
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_qsum[W];
  __shared__ float s_med[W][4];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int np = panels(rows);
  uint8_t* s_l = smem;   // [term][panel][m][64 k], swizzled

  const int tid = threadIdx.x;
  const int group = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  uint8_t* mine = s_l + 3 * np * kPanel + group * kWorkerBytes;
  float* s_t = reinterpret_cast<float*>(mine);            // T1^T block [w][m]; buffer64 [p][q]
  uint8_t* s_x = mine;                                    // 2 X buffers, during stage 1
  float* s_r = reinterpret_cast<float*>(mine + kTBytes);  // R^T block [w][q], swizzled
  uint8_t* scratch = mine + kTBytes;                      // the epilogue's, after stage 2

  // L's three terms, once per block: 16-byte chunk c (8 k) of row m of a
  // panel at m * 128 + ((c ^ (m & 7)) << 4); zeros past `rows`.
  {
    const uint16_t* lsplit[3] = {l1, l2, l3};
    // 16-byte copies need rows of whole chunks and aligned operators
    const bool vec = rows % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(l1) | reinterpret_cast<uintptr_t>(l2) |
                      reinterpret_cast<uintptr_t>(l3)) % 16 == 0;
    for (int e = tid; e < 3 * np * kRows * 8; e += kWG * W) {
      const int c = e & 7, m = (e >> 3) & 63, pp = e >> 9;   // pp = term * np + panel
      const int s = pp / np, k0 = (pp % np) * kKChunk + 8 * c;
      const uint16_t* src = lsplit[s] + static_cast<size_t>(m) * rows + k0;
      uint8_t* dst = s_l + pp * kPanel + m * 128 + ((c ^ (m & 7)) << 4);
      if (vec) {
        cp_async16(dst, k0 < rows ? src : lsplit[s], k0 < rows);
      } else {
        uint32_t h[4] = {0u, 0u, 0u, 0u};
        for (int i = 0; i < 8; ++i)
          if (k0 + i < rows) h[i >> 1] |= static_cast<uint32_t>(__ldg(src + i)) << (16 * (i & 1));
        *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();   // the only block-wide barrier

  const int kpad = (rows + 31) / 32 * 32;            // k-steps come in pairs
  const int n_chunks = (kpad + kKChunk - 1) / kKChunk;
  const int n_cblk = (cols + kNBlk - 1) / kNBlk;
  const bool vec_x = cols % 16 == 0 && reinterpret_cast<uintptr_t>(lumas) % 16 == 0;
  const uint32_t l_addr = smem_addr(s_l), x_addr = smem_addr(s_x);
  const int r0 = warp * 16 + (lane >> 2);            // accumulator rows r0, r0 + 8
  const int cq = 2 * (lane & 3);                     // column of d[4i] within n8 block i
  const int ty = t >> 3, tx = t & 7;                 // stage 2: rows 4 ty.., columns 4 tx.., 32 + 4 tx..
  const int pk = t >> 2, pm = t & 3;                 // X pieces (pk, pm) and (pk + 32, pm)
  auto sync = [group] { bar_sync_group(group); };

  for (int img = blockIdx.x * W + group; img < b; img += gridDim.x * W) {
    const uint8_t* x = lumas + static_cast<size_t>(img) * rows * cols;
    float acc_b[4][8];   // buffer64[4 ty + i][4 tx + j], [..][32 + 4 tx + j - 4]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_b[i][j] = 0.0f;

    uint4 nx0 = load_piece(x, pk, 16 * pm, rows, cols, vec_x);
    uint4 nx1 = load_piece(x, pk + 32, 16 * pm, rows, cols, vec_x);
    for (int cb = 0; cb < n_cblk; ++cb) {
      const int w0 = cb * kNBlk;
      sync();   // stage 2 of the last block (or the last image's epilogue) is over
      // R^T's block [w][q]: group g (4 q) of row w lands at group g ^ (w & 7)
#pragma unroll
      for (int it = 0; it < kNBlk * 16 / kWG; ++it) {
        const int e = it * kWG + t;
        const int w = e >> 4, g = e & 15;
        const bool ok = w0 + w < cols;
        cp_async16(s_r + w * kRows + ((g ^ (w & 7)) << 2),
                   ok ? rt + static_cast<size_t>(w0 + w) * kRows + 4 * g : rt, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");

      // ---- stage 1: the three running sums of T1[:, w0 .. w0 + 63] ----
      float run0[32], run1[32], run2[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) run0[i] = run1[i] = run2[i] = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        uint8_t* xb = s_x + (c & 1) * kPanel;
        store_piece(xb, pk, pm, nx0);
        store_piece(xb, pk + 32, pm, nx1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        sync();
        {   // the next chunk's pixels fly behind this chunk's MMAs
          const bool last = c + 1 == n_chunks;
          const int h0 = last ? 0 : (c + 1) * kKChunk, wn = last ? w0 + kNBlk : w0;
          nx0 = load_piece(x, h0 + pk, wn + 16 * pm, rows, cols, vec_x);
          nx1 = load_piece(x, h0 + pk + 32, wn + 16 * pm, rows, cols, vec_x);
        }
        const int units = min(kKChunk, kpad - c * kKChunk) / 32;   // pairs of k-steps
        const uint32_t a0 = l_addr + c * kPanel, b0 = x_addr + (c & 1) * kPanel;
        const uint32_t term = np * kPanel;
        // wgmma j of a unit: k-step 2 u + j / 3, term j % 3; results
        // alternate between f0 and f1, one MMA ahead of the adds
        float f0[32], f1[32];
        wgmma_fresh(f0, sw128_desc(a0), sw128_desc(b0));
        for (int u = 0; u < units; ++u) {
          const uint32_t ak = a0 + u * 64, bk = b0 + u * 4096;
          wgmma_fresh(f1, sw128_desc(ak + term), sw128_desc(bk));
          wgmma_wait<1>();
          add_into(run0, f0);
          wgmma_fresh(f0, sw128_desc(ak + 2 * term), sw128_desc(bk));
          wgmma_wait<1>();
          add_into(run1, f1);
          wgmma_fresh(f1, sw128_desc(ak + 32), sw128_desc(bk + 2048));
          wgmma_wait<1>();
          add_into(run2, f0);
          wgmma_fresh(f0, sw128_desc(ak + 32 + term), sw128_desc(bk + 2048));
          wgmma_wait<1>();
          add_into(run0, f1);
          wgmma_fresh(f1, sw128_desc(ak + 32 + 2 * term), sw128_desc(bk + 2048));
          wgmma_wait<1>();
          add_into(run1, f0);
          if (u + 1 < units) {
            wgmma_fresh(f0, sw128_desc(ak + 64), sw128_desc(bk + 4096));
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          add_into(run2, f1);
        }
      }
      sync();   // every warp's MMAs are complete: the X buffers are free
      // T1 = (T1_1 + T1_2) + T1_3, transposed into [w][m]
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = r0 + (e >= 2 ? 8 : 0), w = 8 * i + cq + (e & 1);
          s_t[w * kTPitch + m] =
              __fadd_rn(__fadd_rn(run0[4 * i + e], run1[4 * i + e]), run2[4 * i + e]);
        }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      sync();

      // ---- stage 2: buffer64[p][q] += sum_w T1[p][w0 + w] * R[q][w0 + w], w ascending ----
#pragma unroll 4
      for (int w = 0; w < kNBlk; ++w) {
        const float4 a = *reinterpret_cast<const float4*>(s_t + w * kTPitch + 4 * ty);
        const float* rw = s_r + w * kRows;
        const float4 p0 = *reinterpret_cast<const float4*>(rw + ((tx ^ (w & 7)) << 2));
        const float4 p1 = *reinterpret_cast<const float4*>(rw + (((8 + tx) ^ (w & 7)) << 2));
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc_b[i][j] = fmaf(av[i], bv[j], acc_b[i][j]);
      }
    }

    sync();   // the last stage 2 has read T1^T; it becomes buffer64
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = s_t + (4 * ty + i) * kTPitch;
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(acc_b[i][0], acc_b[i][1], acc_b[i][2], acc_b[i][3]);
      *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
          make_float4(acc_b[i][4], acc_b[i][5], acc_b[i][6], acc_b[i][7]);
    }
    if (t == 0) s_qsum[group] = 0;
    sync();
    pdq_epilogue::finish_image<kWG>(
        t, s_t, scratch, &s_qsum[group], s_med[group], d16,
        dihedral != nullptr ? dihedral + static_cast<size_t>(img) * 8 * 32 : nullptr,
        quality + img, coeffs + static_cast<size_t>(img) * 256, sync);
  }
}

template <int W>
int launch(int sms, cudaStream_t st, const void* lumas, int b, int rows, int cols,
           const void* l1, const void* l2, const void* l3, const void* r_t, const void* d16,
           void* coeffs, void* quality, void* dihedral) {
  const int smem = smem_bytes(rows, W);
  const cudaError_t attr = cudaFuncSetAttribute(
      pdq_coeffs_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (b + W - 1) / W;
  pdq_coeffs_kernel<W><<<blocks < sms ? blocks : sms, kWG * W, smem, st>>>(
      static_cast<const uint8_t*>(lumas), b, rows, cols, static_cast<const uint16_t*>(l1),
      static_cast<const uint16_t*>(l2), static_cast<const uint16_t*>(l3),
      static_cast<const float*>(r_t), static_cast<const float*>(d16),
      static_cast<float*>(coeffs), static_cast<float*>(quality),
      static_cast<uint8_t*>(dihedral));
  return 0;
}

}  // namespace

// r_t: R transposed, (cols, 64) f32, 16-byte aligned.  dihedral may be
// null: the kernel then stops after the coefficients.
extern "C" int rupp_pdq_coeffs(const void* lumas, int b, int rows, int cols, const void* l1,
                               const void* l2, const void* l3, const void* r_t,
                               const void* d16, void* coeffs, void* quality, void* dihedral,
                               void* stream) {
  if (rows < 1 || rows > kMaxRows || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  // two warpgroups a block where the L terms leave room for both
  const int rc = smem_bytes(rows, 2) + 256 <= kSmemLimit
                     ? launch<2>(sms, st, lumas, b, rows, cols, l1, l2, l3, r_t, d16, coeffs,
                                 quality, dihedral)
                     : launch<1>(sms, st, lumas, b, rows, cols, l1, l2, l3, r_t, d16, coeffs,
                                 quality, dihedral);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
