// K6: the all-pairs Hamming count sweep as int8 tensor-core dots.
//
// Replaces _prof_nz.py::_rowcount_kernel_dg, the JAX package's int8
// form of K3 (rupphash_tpu/ops/hamming_pallas.py::_rowcount_kernel)
// that contracts the base tile on its last dimension (q . b^T).  Same
// input as the TPU kernel: +/-1 int8 encodings (V, Npad, nbits), and
// the same contract as K3: per-row counts over pairs j > i, both below
// n_total, with
//
//   max over variants v of dot(q_v(i), b_0(j)) >= nbits - 2 sim
//   (>= nbits, i.e. distance 0, when either row is low-confidence).
//
// Dots of +/-1 vectors are exact in int32, so the counts equal K3's
// bit for bit.
//
// What bounds it on this card: 2 * nbits int8 operations per pair and
// variant, 2.0e13 at N=100k, V=8 (10 ms at the 1,979 TOP/s int8 peak).
// Each warp issues mma.sync.m16n8k32 s8.s8.s32 from registers: A (16
// query rows) comes from global memory through L1 for one variant at a
// time, B (8 base rows) from a 64-row base chunk in shared memory.  One
// 16-byte shared load feeds two MMAs, so shared-memory bandwidth, not
// the tensor cores, is the likely limit; wgmma with TMA-fed tiles is
// the later route to the peak.
//
// The k order inside an MMA is free as long as A and B use the same
// one: thread t of a quad loads 16 contiguous bytes per 64-byte k-pair
// and uses bytes [0,4) and [4,8) as the two halves of the first MMA's
// fragment and [8,12), [12,16) for the second.
//
// Layout: block (bj, qi) = 64 query rows (4 warps x 16) x 1024 base rows
// walked in 64-row chunks; tiles wholly at or below the diagonal exit at
// once, chunks at or below it are skipped.  Row counts are reduced over
// the quad and summed over blocks with integer atomicAdd.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kQueryRows = 16 * kWarps;  // per block
constexpr int kBaseTile = 1024;          // per block (npad % kBaseTile == 0)
constexpr int kChunk = 64;               // base rows staged per step
constexpr int kNTiles = kChunk / 8;

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// KB: bytes (= bits) per +/-1 row, 256 (PDQ) or 64 (pHash).
template <int NV, int KB>
__global__ void __launch_bounds__(32 * kWarps)
hamming_rowcount_mma_kernel(const int8_t* __restrict__ pm1,   // (NV, npad, KB)
                            const int32_t* __restrict__ low,  // (npad,)
                            int npad, int n_total, int sim,
                            int32_t* __restrict__ counts) {   // (npad,), zeroed
  constexpr int kPairs = KB / 64;  // 16-byte loads per row and thread
  // row pitch in shared memory: 16 words mod 32, so the 8 rows a
  // quarter-warp reads in one 16-byte phase hit disjoint banks
  constexpr int kPitch = ((KB / 4) % 32 == 16) ? KB : KB + 64;
  const int q0 = blockIdx.y * kQueryRows;
  const int b0 = blockIdx.x * kBaseTile;
  if (b0 + kBaseTile - 1 <= q0 || b0 >= n_total || q0 >= n_total) return;

  __shared__ __align__(16) int8_t s_b[kChunk * kPitch];
  __shared__ int32_t s_low[kChunk];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int low0 = low[row0], low1 = low[row1];
  const int thr_ok = KB - 2 * sim;
  int cnt0 = 0, cnt1 = 0;

  const int cend = min(b0 + kBaseTile, n_total);
  for (int c0 = b0; c0 < cend; c0 += kChunk) {
    if (c0 + kChunk - 1 <= q0) continue;  // every j <= every i of the block
    __syncthreads();                      // the previous chunk is consumed
    for (int e = threadIdx.x; e < kChunk * KB / 16; e += 32 * kWarps) {
      const int r = e / (KB / 16), k = e % (KB / 16);
      *reinterpret_cast<uint4*>(s_b + r * kPitch + k * 16) =
          reinterpret_cast<const uint4*>(pm1 + static_cast<size_t>(c0 + r) * KB)[k];
    }
    for (int e = threadIdx.x; e < kChunk; e += 32 * kWarps) s_low[e] = low[c0 + e];
    __syncthreads();

    int best[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) best[n][c] = INT_MIN;
#pragma unroll 1
    for (int v = 0; v < NV; ++v) {
      const int8_t* qa = pm1 + (static_cast<size_t>(v) * npad + row0) * KB + t * 16;
      const int8_t* qb = qa + 8 * KB;
      uint4 a_lo[kPairs], a_hi[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        a_lo[p] = __ldg(reinterpret_cast<const uint4*>(qa + p * 64));
        a_hi[p] = __ldg(reinterpret_cast<const uint4*>(qb + p * 64));
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        int acc[4] = {0, 0, 0, 0};
        const int8_t* bp = s_b + (n * 8 + g) * kPitch + t * 16;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const uint4 bb = *reinterpret_cast<const uint4*>(bp + p * 64);
          mma_s8(acc, a_lo[p].x, a_hi[p].x, a_lo[p].y, a_hi[p].y, bb.x, bb.y);
          mma_s8(acc, a_lo[p].z, a_hi[p].z, a_lo[p].w, a_hi[p].w, bb.z, bb.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) best[n][c] = max(best[n][c], acc[c]);
      }
    }

    // accumulator (n, c): row row0 for c < 2, row1 otherwise; column
    // c0 + n*8 + 2t + (c & 1)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = n * 8 + 2 * t + (c & 1);
        const int j = c0 + jj;
        const int i = c < 2 ? row0 : row1;
        const int li = c < 2 ? low0 : low1;
        const int need = (li | s_low[jj]) ? KB : thr_ok;
        const int hit = best[n][c] >= need && j > i && j < n_total && i < n_total;
        if (c < 2) cnt0 += hit; else cnt1 += hit;
      }
    }
  }
  cnt0 += __shfl_xor_sync(0xffffffffu, cnt0, 1);
  cnt0 += __shfl_xor_sync(0xffffffffu, cnt0, 2);
  cnt1 += __shfl_xor_sync(0xffffffffu, cnt1, 1);
  cnt1 += __shfl_xor_sync(0xffffffffu, cnt1, 2);
  if (t == 0) {
    if (cnt0) atomicAdd(counts + row0, cnt0);
    if (cnt1) atomicAdd(counts + row1, cnt1);
  }
}

template <int NV, int KB>
void launch(dim3 grid, cudaStream_t st, const void* pm1, const void* low, int npad, int n_total,
            int sim, void* counts) {
  hamming_rowcount_mma_kernel<NV, KB><<<grid, 32 * kWarps, 0, st>>>(
      static_cast<const int8_t*>(pm1), static_cast<const int32_t*>(low), npad, n_total, sim,
      static_cast<int32_t*>(counts));
}

}  // namespace

// nbits: 256 or 64; nv: 1 or 8.
extern "C" int rupp_hamming_rowcount_mma(const void* pm1, const void* low, int nv, int nbits,
                                         int npad, int n_total, int sim, void* counts,
                                         void* stream) {
  if (npad % kBaseTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(npad / kBaseTile, npad / kQueryRows);
  const auto st = static_cast<cudaStream_t>(stream);
  if (npad > 0) {
    switch (nv * 1000 + nbits) {
      case 1256: launch<1, 256>(grid, st, pm1, low, npad, n_total, sim, counts); break;
      case 8256: launch<8, 256>(grid, st, pm1, low, npad, n_total, sim, counts); break;
      case 1064: launch<1, 64>(grid, st, pm1, low, npad, n_total, sim, counts); break;
      case 8064: launch<8, 64>(grid, st, pm1, low, npad, n_total, sim, counts); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
