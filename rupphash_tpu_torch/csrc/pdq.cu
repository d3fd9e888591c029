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
//   4 sign patterns -> lower median (128th smallest) by a bitonic sort
//   -> bits -> 8 dihedral variants packed as bytes (byte 31 - idx/8,
//   bit idx%8; transposed variants read bit c*16+r for output r*16+c).
//
// Mixed working shapes share one launch: planes are zero-padded to
// (hp, wp) and each image picks its operators by shape_idx from
// L^T (S, hp, 64) / R^T (S, wp, 64), whose padded rows are zero.  Every
// sum runs sequentially from index 0 upwards, so the padded zero terms
// come last and leave the result bit-identical to the tight shape.  The
// wrapper pads wp to a multiple of 16 and hp to a multiple of 4 the same
// way, for the 16-byte copies below.
//
// What bounds it on this card: stages A and B are 64 * hp * (wp + 64)
// fp32 FMAs per image (10.6 M at 288x512), 5.4 GFLOP per 256-image
// batch, 0.081 ms at the 67 TFLOP/s fp32 peak; everything after them is
// a few hundred thousand operations.  Exactness rules the arithmetic:
// the hash bits and the quality must match the plain version, so the
// kernel uses fp32 FMA with IEEE division, no fast math, and no
// tensor-core (TF32/bf16) arithmetic, and every output's sum runs in
// index order.  Within those rules the design keeps the FMA pipes fed:
//
//   * register tiles over k-major operands: X^T is staged [k][h] and R^T
//     [k][p], so for each k a thread of stage A loads its RT rows (in
//     16-byte groups of four where it can) and its 8 columns (two
//     16-byte loads) and runs the RT x 8 FMAs of their outer product
//     (stage B: L^T [k][p] and XR [k][q], 4 x 4 outputs from two loads);
//     every accumulator still sums k upwards;
//   * overlap: the next k chunk of X (u8) and R (f32), and in stage B of
//     L, is in flight with cp.async while the current chunk is
//     multiplied (two buffers each); X is converted to f32 and
//     transposed once per chunk, not per use;
//   * occupancy: a block covers up to 384 rows of the image per round
//     (H = hp rounded up to 32 when hp <= 384, two rounds of hp/2 above)
//     with 256 threads, one block per SM, so a 256-image batch is 256
//     blocks over the 132 SMs; each thread of stage A owns RT = H / 32
//     rows (a kernel per RT), so the 8 warps, two on each of the SM's
//     four schedulers, carry equal work whatever the shape;
//   * conflict-free shared loads: thread (ty, tx) owns rows 128 g + 4 ty
//     (four per group g), then single rows 128 G4 + 32 s + ty, and
//     columns 4 tx and 32 + 4 tx, so the 8 threads of a quarter warp
//     share their row loads and read 128 contiguous bytes of columns;
//   * epilogue (pdq_epilogue.cuh, shared with K2): D16 is staged in
//     shared memory (transposed), each thread of the D16 . buffer64
//     product runs four independent chains, and
//     the four medians come from one bitonic sort network (36 steps of
//     128 compare-exchanges per variant) instead of 256 x 256 rank
//     comparisons; stage B's full chunks are unrolled.
//
// The k-major operands need RT + 8 registers per step instead of the 64
// of a k4-step over row-major tiles, which leaves the compiler room to
// load the next k's operands while the current outer product runs.
//
// Shared memory (dynamic): the staging of stage A (R^T x 2, X^T f32, X
// u8 x 2), reused for XR of the round and later for the epilogue; L^T
// x 2; buffer64.  For H = 288, 105 KB.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdq_epilogue.cuh"

namespace {

// 8 warps, two on each scheduler; stage B and the epilogue give each
// thread one of their 256 outputs
constexpr int kThreads = 256;
constexpr int kMaxRows = 384;      // rows of the image per round
constexpr int kTile = pdq_epilogue::kTile;   // buffer64 side
constexpr int kChunk = 32;         // reduction depth staged per step
constexpr int kXPieces = kChunk / 16;  // 16-byte u8 pieces per staged X row
constexpr int kPad = pdq_epilogue::kPad;     // row pitch of buffer64
constexpr int kOpBytes = 2 * kChunk * kTile * 4;   // two staged R^T or L^T chunks

// Shared memory, in bytes from the start: region A holds the stage-A
// staging (R^T x 2, X^T as f32, X as u8 x 2), then XR of the round, then
// the epilogue's scratch; L^T x 2 and buffer64 follow it.
struct Layout {
  int rows;      // H: rows per round
  int x_t;       // [kChunk][rows] f32, k-major
  int x_u8;      // 2 x [rows][kChunk] u8
  int region_a;
  int l_t;       // 2 x [kChunk][64] f32
  int buf;       // [64][kPad] f32
  int total;
};

__host__ __device__ inline Layout make_layout(int rows) {
  Layout l;
  l.rows = rows;
  l.x_t = kOpBytes;   // R^T x 2 come first
  l.x_u8 = l.x_t + kChunk * rows * 4;
  const int staging = l.x_u8 + 2 * rows * kChunk;
  const int xr = rows * kTile * 4;
  const int scratch = pdq_epilogue::kScratchBytes;
  int a = staging > xr ? staging : xr;
  a = a > scratch ? a : scratch;
  l.region_a = (a + 15) & ~15;
  l.l_t = l.region_a;
  l.buf = l.l_t + kOpBytes;
  l.total = l.buf + kTile * kPad * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage A chunk: X rows [h0, h0 + rows) x columns [w0, w0 + kChunk) as u8,
// and rows [w0, w0 + kChunk) of R^T (64 f32 each); pieces outside the image
// are zeros.
__device__ __forceinline__ void stage_a_copy(uint8_t* x_u8, float* r_t, const uint8_t* x,
                                              const float* rt, int rows, int h0, int w0,
                                              int hp, int wp) {
  for (int e = threadIdx.x; e < rows * kXPieces + kChunk * 16; e += blockDim.x) {
    if (e < rows * kXPieces) {
      const int r = e / kXPieces, m = e % kXPieces;
      const int h = h0 + r, w = w0 + 16 * m;
      const bool ok = h < hp && w < wp;
      cp_async16(x_u8 + r * kChunk + 16 * m, ok ? x + static_cast<size_t>(h) * wp + w : x, ok);
    } else {
      const int f = e - rows * kXPieces;
      const int k = f >> 4, m = f & 15;
      const bool ok = w0 + k < wp;
      cp_async16(r_t + k * kTile + 4 * m, ok ? rt + static_cast<size_t>(w0 + k) * kTile + 4 * m : rt,
                 ok);
    }
  }
  cp_async_commit();
}

// Stage B chunk: rows [h, h + kChunk) of L^T (64 f32 each), zeros past hp.
__device__ __forceinline__ void stage_b_copy(float* l_t, const float* lt, int h, int hp) {
  for (int e = threadIdx.x; e < kChunk * 16; e += blockDim.x) {
    const int k = e >> 4, m = e & 15;
    const bool ok = h + k < hp;
    cp_async16(l_t + k * kTile + 4 * m, ok ? lt + static_cast<size_t>(h + k) * kTile + 4 * m : lt,
               ok);
  }
  cp_async_commit();
}

template <int RT>   // rows of stage A per thread: H = 32 RT
__global__ void __launch_bounds__(kThreads, 1)
pdq_hash_kernel(const uint8_t* __restrict__ lumas, int hp, int wp, int rows,
                const float* __restrict__ lt_unique,   // (S, hp, 64): L^T
                const float* __restrict__ rt_unique,   // (S, wp, 64): R^T
                const int32_t* __restrict__ shape_idx,
                const float* __restrict__ d16,
                uint8_t* __restrict__ dihedral,
                float* __restrict__ quality,
                float* __restrict__ coeffs) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_med[4];
  __shared__ int s_qsum;
  const Layout lay = make_layout(rows);
  float* const r_stage = reinterpret_cast<float*>(smem);               // 2 x [32][64]
  float* const x_t = reinterpret_cast<float*>(smem + lay.x_t);         // [32][rows]
  uint8_t* const x_u8 = smem + lay.x_u8;                               // 2 x [rows][32]
  float* const xr = reinterpret_cast<float*>(smem);                    // [rows][64], after stage A
  float* const l_stage = reinterpret_cast<float*>(smem + lay.l_t);     // 2 x [32][64]
  float* const buf = reinterpret_cast<float*>(smem + lay.buf);         // [64][kPad]

  const int t = threadIdx.x;
  const int img = blockIdx.x;
  const uint8_t* x = lumas + static_cast<size_t>(img) * hp * wp;
  const int s = shape_idx != nullptr ? shape_idx[img] : 0;   // null: one operator pair
  const float* lt = lt_unique + static_cast<size_t>(s) * hp * kTile;
  const float* rt = rt_unique + static_cast<size_t>(s) * wp * kTile;

  if (t == 0) s_qsum = 0;
  for (int e = t; e < kTile * kPad; e += blockDim.x) buf[e] = 0.0f;

  // stage A roles: thread (ty, tx), ty < 32, owns the RT rows
  // a_row(i) (float4 groups 128 g + 4 ty + 0..3, then single rows
  // 128 G4 + 32 s + ty) and columns {4 tx, 32 + 4 tx} + 0..3
  constexpr int G4 = RT / 4, RS = RT % 4;
  const int ay = t >> 3, ax = t & 7;
  auto a_row = [&](int i) {
    return i < 4 * G4 ? 128 * (i >> 2) + 4 * ay + (i & 3) : 128 * G4 + 32 * (i - 4 * G4) + ay;
  };
  // stage B roles: rows p = 4 by .. 4 by + 3, columns q = 4 bx .. 4 bx + 3
  const int by = t >> 4, bx = t & 15;
  const int n_wc = (wp + kChunk - 1) / kChunk;

  for (int h0 = 0; h0 < hp; h0 += rows) {
    // ---- stage A: XR[h][p] = sum_w X[h][w] * R[p][w], w ascending ----
    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    stage_a_copy(x_u8, r_stage, x, rt, rows, h0, 0, hp, wp);
    for (int c = 0; c < n_wc; ++c) {
      cp_async_wait_all();
      __syncthreads();   // chunk c landed; chunk c - 1 is consumed
      if (c + 1 < n_wc)
        stage_a_copy(x_u8 + ((c + 1) & 1) * rows * kChunk,
                      r_stage + ((c + 1) & 1) * kChunk * kTile, x, rt, rows, h0,
                      (c + 1) * kChunk, hp, wp);
      // X chunk to f32, transposed to k-major (32 consecutive rows per store)
      const uint8_t* xs = x_u8 + (c & 1) * rows * kChunk;
      for (int r = t; r < rows; r += blockDim.x) {
#pragma unroll
        for (int m = 0; m < kXPieces; ++m) {
          const uint4 v = *reinterpret_cast<const uint4*>(xs + r * kChunk + 16 * m);
          const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 16; ++q)
            x_t[(16 * m + q) * rows + r] =
                static_cast<float>((wv[q >> 2] >> (8 * (q & 3))) & 0xFFu);
        }
      }
      __syncthreads();
      {
        const float* rs = r_stage + (c & 1) * kChunk * kTile;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const float* xk = x_t + k * rows;
          float a[RT];
#pragma unroll
          for (int g = 0; g < G4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(xk + 128 * g + 4 * ay);
            a[4 * g] = v.x;
            a[4 * g + 1] = v.y;
            a[4 * g + 2] = v.z;
            a[4 * g + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < RS; ++i) a[4 * G4 + i] = xk[128 * G4 + 32 * i + ay];
          const float4 b0 = *reinterpret_cast<const float4*>(rs + k * kTile + 4 * ax);
          const float4 b1 = *reinterpret_cast<const float4*>(rs + k * kTile + 32 + 4 * ax);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();   // the staging region becomes XR
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* row = xr + a_row(i) * kTile;
      *reinterpret_cast<float4*>(row + 4 * ax) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 32 + 4 * ax) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }

    // ---- stage B: buf64[p][q] += sum_h L[p][h0 + h] * XR[h][q], h ascending ----
    const int n_h = min(rows, hp - h0);
    const int n_hc = (n_h + kChunk - 1) / kChunk;
    float accb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accb[i][j] = buf[(4 * by + i) * kPad + 4 * bx + j];
    stage_b_copy(l_stage, lt, h0, hp);
    for (int c = 0; c < n_hc; ++c) {
      cp_async_wait_all();
      __syncthreads();   // chunk c landed, chunk c - 1 consumed; XR published
      if (c + 1 < n_hc)
        stage_b_copy(l_stage + ((c + 1) & 1) * kChunk * kTile, lt, h0 + (c + 1) * kChunk, hp);
      const float* ls = l_stage + (c & 1) * kChunk * kTile;
      const float* xs = xr + c * kChunk * kTile;
      const int kmax = min(kChunk, n_h - c * kChunk);
      auto step = [&](int k) {
        const float4 lv = *reinterpret_cast<const float4*>(ls + k * kTile + 4 * by);
        const float4 xv = *reinterpret_cast<const float4*>(xs + k * kTile + 4 * bx);
        const float l4[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          accb[i][0] = fmaf(l4[i], xv.x, accb[i][0]);
          accb[i][1] = fmaf(l4[i], xv.y, accb[i][1]);
          accb[i][2] = fmaf(l4[i], xv.z, accb[i][2]);
          accb[i][3] = fmaf(l4[i], xv.w, accb[i][3]);
        }
      };
      if (kmax == kChunk) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) step(k);
      } else {
        for (int k = 0; k < kmax; ++k) step(k);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(buf + (4 * by + i) * kPad + 4 * bx) =
          make_float4(accb[i][0], accb[i][1], accb[i][2], accb[i][3]);
    __syncthreads();   // buffer64 holds this round; the stage-A region is free
  }

  // buffer64 is complete; the epilogue's scratch is the stage-A region
  pdq_epilogue::finish_image<kThreads>(
      t, buf, smem, &s_qsum, s_med, d16, dihedral + static_cast<size_t>(img) * 8 * 32,
      quality + img, coeffs + static_cast<size_t>(img) * 256, [] { __syncthreads(); });
}

struct Launch {
  int b, hp, wp, rows;
  const void *lumas, *lt_unique, *rt_unique, *shape_idx, *d16;
  void *dihedral, *quality, *coeffs;
  cudaStream_t stream;
};

template <int RT>
int launch(const Launch& a) {
  const Layout lay = make_layout(a.rows);
  const cudaError_t attr = cudaFuncSetAttribute(
      pdq_hash_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  pdq_hash_kernel<RT><<<a.b, kThreads, lay.total, a.stream>>>(
      static_cast<const uint8_t*>(a.lumas), a.hp, a.wp, a.rows, static_cast<const float*>(a.lt_unique),
      static_cast<const float*>(a.rt_unique), static_cast<const int32_t*>(a.shape_idx),
      static_cast<const float*>(a.d16), static_cast<uint8_t*>(a.dihedral),
      static_cast<float*>(a.quality), static_cast<float*>(a.coeffs));
  return 0;
}

}  // namespace

// hp % 4 == 0 and wp % 16 == 0 (the wrapper pads), both <= 512.  The
// operators come transposed: lt_unique (S, hp, 64), rt_unique (S, wp, 64);
// shape_idx may be null when S == 1.
extern "C" int rupp_pdq_hash(const void* lumas, int b, int hp, int wp,
                             const void* lt_unique, const void* rt_unique,
                             const void* shape_idx, const void* d16,
                             void* dihedral, void* quality, void* coeffs,
                             void* stream) {
  if (hp % 4 || wp % 16 || hp < 1 || hp > 512 || wp < 1 || wp > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0) {
    const int rounds = (hp + kMaxRows - 1) / kMaxRows;
    const int rows = 32 * ((hp + 32 * rounds - 1) / (32 * rounds));
    const Launch args{b, hp, wp, rows, lumas, lt_unique, rt_unique, shape_idx, d16,
                      dihedral, quality, coeffs, static_cast<cudaStream_t>(stream)};
    int err = 0;
    switch (rows / 32) {
      case 1: err = launch<1>(args); break;
      case 2: err = launch<2>(args); break;
      case 3: err = launch<3>(args); break;
      case 4: err = launch<4>(args); break;
      case 5: err = launch<5>(args); break;
      case 6: err = launch<6>(args); break;
      case 7: err = launch<7>(args); break;
      case 8: err = launch<8>(args); break;
      case 9: err = launch<9>(args); break;
      case 10: err = launch<10>(args); break;
      case 11: err = launch<11>(args); break;
      case 12: err = launch<12>(args); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rupp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
