// K3: all-pairs Hamming count sweep, and K4: hot-row bitmask extraction.
//
// K3 replaces rupphash_tpu/ops/hamming_pallas.py::_rowcount_kernel and
// K4 replaces ::_extract_kernel.  Both apply one predicate to a pair
// (query row i, base row j):
//
//   d    = min over query variants v of popcount(q_v(i) XOR b_0(j))
//   keep = d <= (low(i) | low(j) ? 0 : sim)
//          and j > i and j < n_total and i < n_total
//
// The base side is variant slot 0 only.  Hashes arrive packed, as the
// (V, Npad, nbytes) u8 tensor the JAX package shipped to the device
// before unpacking it: 32 bytes per 256-bit PDQ hash, 8 per 64-bit
// pHash.
//
// K3 computes the test as the TPU did, as +/-1 int8 dots on tensor
// cores: dot = nbits - 2 d, keep when max over v of dot >= nbits - 2 sim
// (>= nbits when either row is low-confidence).  Dots of +/-1 vectors
// are exact in int32, so the counts are exact.
//
// What bounds K3 on this card: 2 * nbits int8 operations per pair and
// variant, 2.05e13 at N=100k, V=8, i.e. 10.3 ms at the 1,979 TOP/s int8
// peak; the packed input is 25.6 MB.  The peak is reached only through
// wgmma, so the design is a wgmma GEMM with the max, the threshold and
// the row count fused into its epilogue:
//
//   * work item = 64 query rows x a run of up to 64 base tiles of 128
//     rows, all on or above the diagonal (the host builds the list,
//     ops/hamming_cuda.py::sweep_items); persistent blocks, one per SM,
//     take items from a global counter;
//   * the item's query tile, all V variants, is expanded from packed
//     bits to +/-1 int8 once into shared memory (V x 16 KB) and stays
//     there for the whole run of base tiles;
//   * two consumer warpgroups take every other base tile; each expands
//     its tile's packed rows (prefetched into registers during the
//     previous tile's MMAs) into its own 32 KB buffer, so device memory
//     is read packed and one warpgroup's staging and epilogue overlap
//     the other's MMAs;
//   * per variant, 8 (PDQ) or 2 (pHash) wgmma.m64n128k32.s32.s8.s8 from
//     shared memory into one of two register accumulators, so variant
//     v + 1 runs on the tensor cores while the max folds variant v;
//   * epilogue in registers: threshold, j > i mask, row counts summed
//     over the item, one shared then one global integer atomicAdd per
//     row per item.
//
// Shared layout of every +/-1 tile: 128-byte rows (one 128B swizzle
// span, 128 k values), 16-byte chunk c of row r at
// r * 128 + ((c ^ (r & 7)) << 4), 1024-byte aligned; a 256-bit hash
// fills two such panels.  The k order inside a row is free as long as
// query and base use the same one: chunk c holds bits [16c, 16c + 16).
//
// K4 is the same GEMM with another epilogue.  What bounds it: 2 * nbits
// int8 operations per (hot row, later base row, variant), 0.25 ms for
// 1,794 hot rows at N=100k; the mask it writes is almost all zeros.  Its
// design on top of K3's tiles:
//
//   * the query tile is 64 gathered hot rows (their variants, their own
//     row indices qidx and low flags), the base side its own pointer;
//   * work item = (query tile, run of base tiles); the first base tile of
//     a query tile is the one holding its smallest live qidx + 1, derived
//     in the kernel, so no tile wholly at or under the diagonal is
//     computed (tests/test_torch_extract.py walks the same items on the
//     host); persistent blocks take items from a
//     counter;
//   * epilogue in registers: max over variants, threshold, j > qidx,
//     range masks, then the predicate bits of a row's 128 columns, which
//     lie two per lane in the four lanes of a quad, are gathered by
//     shuffles into one 32-bit word per lane (bit j % 8 of byte j / 8)
//     and stored only where nonzero: the wrapper clears the mask first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ----------------------------------------------------------------------------
// K3
// ----------------------------------------------------------------------------

constexpr int kQRows = 64;                  // query rows per item (wgmma M)
constexpr int kBRows = 128;                 // base rows per tile (wgmma N)
constexpr int kGroups = 2;                  // consumer warpgroups
constexpr int kSweepThreads = 128 * kGroups;
constexpr int kPanelQ = kQRows * 128;       // bytes of one query panel
constexpr int kPanelB = kBRows * 128;       // bytes of one base panel

template <int NB>  // packed bytes per hash: 32 or 8
struct SweepShape {
  static constexpr int kPanels = NB == 32 ? 2 : 1;     // 128-byte panels per row
  static constexpr int kSteps = NB * 8 / 32;           // k32 wgmma steps
  static constexpr int kChunks = NB / 2;               // 16-byte +/-1 chunks per row
};

template <int NV, int NB>
constexpr int sweep_smem_bytes() {
  return 1024 /* alignment slack */ + NV * SweepShape<NB>::kPanels * kPanelQ +
         kGroups * SweepShape<NB>::kPanels * kPanelB +
         4 * (kQRows + kGroups * kBRows + kQRows) + 16;
}

// 4 packed bits -> 4 bytes of +1 (bit set) / -1 (bit clear).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  const uint32_t x = (nib * 0x00204081u) & 0x01010101u;
  return 0xFFFFFFFFu ^ (x * 0xFEu);
}

// Chunk c (bits [16c, 16c + 16)) of a packed row as 16 +/-1 bytes.
__device__ __forceinline__ uint4 expand16(uint32_t half) {
  return make_uint4(spread4(half & 0xFu), spread4((half >> 4) & 0xFu),
                    spread4((half >> 8) & 0xFu), spread4((half >> 12) & 0xFu));
}

template <int NB>
struct PackedRow {
  uint32_t w[NB / 4];
};

template <int NB>
__device__ __forceinline__ PackedRow<NB> load_row(const uint8_t* p) {
  PackedRow<NB> r;
  if constexpr (NB == 32) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
  } else {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = a.x; r.w[1] = a.y;
  }
  return r;
}

// Write one packed row as +/-1 int8 into a swizzled tile of `rows` rows.
template <int NB>
__device__ __forceinline__ void store_row(uint8_t* tile, int rows, int r,
                                          const PackedRow<NB>& row) {
#pragma unroll
  for (int c = 0; c < SweepShape<NB>::kChunks; ++c) {
    const uint32_t half = (row.w[c >> 1] >> (16 * (c & 1))) & 0xFFFFu;
    const int panel = c >> 3, cc = c & 7;
    *reinterpret_cast<uint4*>(tile + panel * rows * 128 + r * 128 + ((cc ^ (r & 7)) << 4)) =
        expand16(half);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: K-major, 128B swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32 s8, smem) . B (128 x 32 s8, smem)^T, s32 accumulate.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// All k steps of one variant against the warpgroup's base tile.
template <int NB>
__device__ __forceinline__ void mma_variant(int (&d)[64], uint32_t q_addr,
                                              uint32_t b_addr) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < SweepShape<NB>::kSteps; ++s) {
    const uint32_t off = (s & 3) * 32;
    wgmma_m64n128k32(d, sw128_desc(q_addr + (s >> 2) * kPanelQ + off),
                     sw128_desc(b_addr + (s >> 2) * kPanelB + off), s > 0);
  }
  wgmma_commit();
}

__device__ __forceinline__ void fold_max(int (&best)[64], int (&d)[64], bool first) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) best[i] = first ? d[i] : max(best[i], d[i]);
}

__device__ __forceinline__ void bar_sync_group(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(128) : "memory");
}

// The run of base tiles [b_begin, b_end) of one work item against the
// query tile resident in s_q: warpgroup `group` takes every other tile,
// expands it into its own buffer, takes the dots of all NV variants and
// hands epi(best, b0) the max over variants for base rows b0 .. b0 + 127
// (best[4i + e]: row r0, column 8i + cq + e; best[4i + 2 + e]: row r1).
// Shared by K3 and K4.
template <int NV, int NB, class Epi>
__device__ __forceinline__ void sweep_base_tiles(const uint8_t* s_q, uint8_t* my_b,
                                                 int32_t* my_blow,
                                                 const uint8_t* __restrict__ base,
                                                 const int32_t* __restrict__ blow,
                                                 int b_begin, int b_end, int group, int t,
                                                 Epi epi) {
  using S = SweepShape<NB>;
  const uint32_t q_addr = smem_addr(s_q), b_addr = smem_addr(my_b);
  int b0 = b_begin + group * kBRows;
  PackedRow<NB> next{};
  int next_low = 1;
  if (b0 < b_end) {
    next = load_row<NB>(base + static_cast<size_t>(b0 + t) * NB);
    next_low = blow[b0 + t];
  }
  for (; b0 < b_end; b0 += kGroups * kBRows) {
    bar_sync_group(group);   // this group's previous tile is consumed
    store_row<NB>(my_b, kBRows, t, next);
    my_blow[t] = next_low;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync_group(group);

    // prefetch the group's next base tile while the tensor cores run
    const int bn = b0 + kGroups * kBRows;
    if (bn < b_end) {
      next = load_row<NB>(base + static_cast<size_t>(bn + t) * NB);
      next_low = blow[bn + t];
    }

    int best[64];
    int acc0[64], acc1[64];
    mma_variant<NB>(acc0, q_addr, b_addr);
    if constexpr (NV == 1) {
      wgmma_wait<0>();
      fold_max(best, acc0, true);
    } else {
#pragma unroll
      for (int v = 1; v < NV; ++v) {
        const uint32_t qv = q_addr + v * S::kPanels * kPanelQ;
        if (v & 1) {
          mma_variant<NB>(acc1, qv, b_addr);
          wgmma_wait<1>();
          fold_max(best, acc0, v == 1);
        } else {
          mma_variant<NB>(acc0, qv, b_addr);
          wgmma_wait<1>();
          fold_max(best, acc1, false);
        }
      }
      wgmma_wait<0>();
      if ((NV - 1) & 1) {
        fold_max(best, acc1, false);
      } else {
        fold_max(best, acc0, false);
      }
    }
    epi(best, b0);
  }
}

template <int NV, int NB>
__global__ void __launch_bounds__(kSweepThreads, 1)
hamming_rowcount_kernel(const uint8_t* __restrict__ packed,  // (NV, npad, NB)
                        const int32_t* __restrict__ low,     // (npad,)
                        const int4* __restrict__ items,      // (n_items,) {q0, b_begin, b_end, 0}
                        int n_items, int* __restrict__ next_item,
                        int npad, int n_total, int sim,
                        int32_t* __restrict__ counts) {      // (npad,), zeroed
  using S = SweepShape<NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* s_q = smem;                                         // NV x kPanels x kPanelQ
  uint8_t* s_b = s_q + NV * S::kPanels * kPanelQ;              // kGroups x kPanels x kPanelB
  int32_t* s_qlow = reinterpret_cast<int32_t*>(s_b + kGroups * S::kPanels * kPanelB);
  int32_t* s_blow = s_qlow + kQRows;                           // kGroups x kBRows
  int32_t* s_count = s_blow + kGroups * kBRows;                // kQRows
  int* s_item = s_count + kQRows;

  const int tid = threadIdx.x;
  const int group = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // accumulator rows of this thread
  const int cq = 2 * (lane & 3);                        // column of d[4i] within n8 block i
  uint8_t* my_b = s_b + group * S::kPanels * kPanelB;
  int32_t* my_blow = s_blow + group * kBRows;
  const int nbits = NB * 8;
  const int need_ok = nbits - 2 * sim;

  for (;;) {
    __syncthreads();   // the previous item is finished everywhere
    if (tid == 0) *s_item = atomicAdd(next_item, 1);
    __syncthreads();
    const int it = *s_item;
    if (it >= n_items) break;
    const int4 item = items[it];
    const int q0 = item.x, b_begin = item.y, b_end = item.z;

    // Query tile: all NV variants of rows q0 .. q0 + 63, once per item.
    for (int e = tid; e < NV * kQRows; e += kSweepThreads) {
      const int v = e / kQRows, r = e % kQRows;
      const PackedRow<NB> row =
          load_row<NB>(packed + (static_cast<size_t>(v) * npad + q0 + r) * NB);
      store_row<NB>(s_q + v * S::kPanels * kPanelQ, kQRows, r, row);
    }
    if (tid < kQRows) {
      s_qlow[tid] = low[q0 + tid];
      s_count[tid] = 0;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int i0 = q0 + r0, i1 = q0 + r1;
    const int ql0 = s_qlow[r0], ql1 = s_qlow[r1];
    int cnt0 = 0, cnt1 = 0;
    sweep_base_tiles<NV, NB>(
        s_q, my_b, my_blow, packed, low, b_begin, b_end, group, t, [&](int (&best)[64], int b0) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = 8 * i + cq + e;
              const int j = b0 + jj;
              const int bl = my_blow[jj];
              const bool jin = j < n_total;
              cnt0 += (best[4 * i + e] >= ((ql0 | bl) ? nbits : need_ok)) & (j > i0) & jin;
              cnt1 += (best[4 * i + 2 + e] >= ((ql1 | bl) ? nbits : need_ok)) & (j > i1) & jin;
            }
          }
        });
    cnt0 += __shfl_xor_sync(0xffffffffu, cnt0, 1);
    cnt0 += __shfl_xor_sync(0xffffffffu, cnt0, 2);
    cnt1 += __shfl_xor_sync(0xffffffffu, cnt1, 1);
    cnt1 += __shfl_xor_sync(0xffffffffu, cnt1, 2);
    if ((lane & 3) == 0) {
      if (cnt0) atomicAdd(s_count + r0, cnt0);
      if (cnt1) atomicAdd(s_count + r1, cnt1);
    }
    __syncthreads();
    if (tid < kQRows && s_count[tid]) atomicAdd(counts + q0 + tid, s_count[tid]);
  }
}

template <int NV, int NB>
int launch_rowcount(int grid, cudaStream_t st, const void* packed, const void* low,
                    const void* items, int n_items, void* next_item, int npad, int n_total,
                    int sim, void* counts) {
  constexpr int smem = sweep_smem_bytes<NV, NB>();
  auto kernel = hamming_rowcount_kernel<NV, NB>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kSweepThreads, smem, st>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(low),
      static_cast<const int4*>(items), n_items, static_cast<int*>(next_item), npad, n_total,
      sim, static_cast<int32_t*>(counts));
  return 0;
}

// ----------------------------------------------------------------------------
// K4
// ----------------------------------------------------------------------------

// A thread's 32 predicate bits of one accumulator row (bit 2i + e: column
// 8i + cq + e) -> the row's 16 mask bytes, four per lane: the word of
// lane q of the quad holds bytes 4q .. 4q + 3, bit c % 8 of byte c / 8
// for column c.  tests/test_torch_extract.py holds the same arithmetic,
// in numpy, against packbits.
__device__ __forceinline__ uint32_t pack_quad(uint32_t w, int q) {
  uint32_t mine = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const uint32_t x = (w >> (8 * d)) & 0xFFu;   // blocks 4d .. 4d + 3, two bits each
    uint32_t s = ((x | (x << 6) | (x << 12) | (x << 18)) & 0x03030303u) << (2 * q);
    s |= __shfl_xor_sync(0xffffffffu, s, 1);
    s |= __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == d) mine = s;
  }
  return mine;
}

template <int NV, int NB>
__global__ void __launch_bounds__(kSweepThreads, 1)
hamming_extract_kernel(const uint8_t* __restrict__ qbits,   // (NV, mq, NB)
                       const uint8_t* __restrict__ base,    // (npad, NB)
                       const int32_t* __restrict__ qlow,    // (mq,)
                       const int32_t* __restrict__ blow,    // (npad,)
                       const int32_t* __restrict__ qidx,    // (mq,)
                       int mq, int npad, int n_total, int sim,
                       int item_tiles, int runs_per_tile, int n_items,
                       int* __restrict__ next_item,
                       uint8_t* __restrict__ out) {         // (mq, npad / 8), zeroed
  using S = SweepShape<NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* s_q = smem;                                         // NV x kPanels x kPanelQ
  uint8_t* s_b = s_q + NV * S::kPanels * kPanelQ;              // kGroups x kPanels x kPanelB
  int32_t* s_qlow = reinterpret_cast<int32_t*>(s_b + kGroups * S::kPanels * kPanelB);
  int32_t* s_blow = s_qlow + kQRows;                           // kGroups x kBRows
  int32_t* s_qidx = s_blow + kGroups * kBRows;                 // kQRows
  int* s_item = s_qidx + kQRows;
  int* s_min = s_item + 1;

  const int tid = threadIdx.x;
  const int group = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int quad = lane & 3, cq = 2 * quad;
  uint8_t* my_b = s_b + group * S::kPanels * kPanelB;
  int32_t* my_blow = s_blow + group * kBRows;
  const int nbits = NB * 8;
  const int need_ok = nbits - 2 * sim;
  const int stride = npad / 8;
  const int n_live = n_total < npad ? n_total : npad;
  const int b_last = (n_live + kBRows - 1) / kBRows * kBRows;
  constexpr int kInert = 0x7fffffff;   // no j lies beyond it

  for (;;) {
    __syncthreads();   // the previous item is finished everywhere
    if (tid == 0) {
      *s_item = atomicAdd(next_item, 1);
      *s_min = kInert;
    }
    __syncthreads();
    const int it = *s_item;
    if (it >= n_items) break;
    const int m0 = it / runs_per_tile * kQRows, run = it % runs_per_tile;
    if (tid < kQRows) {
      const int m = m0 + tid;
      int qi = m < mq ? qidx[m] : n_total;
      qi = qi < n_total ? (qi < -1 ? -1 : qi) : kInert;   // rows at or past n_total are inert
      s_qidx[tid] = qi;
      s_qlow[tid] = m < mq ? qlow[m] : 1;
      if (qi != kInert) atomicMin(s_min, qi);
    }
    __syncthreads();
    // the first base tile that holds a j > qidx of any row of the tile
    const int q_min = *s_min;
    if (q_min == kInert) continue;
    const int b_begin = (q_min + 1) / kBRows * kBRows + run * item_tiles * kBRows;
    if (b_begin >= b_last) continue;
    const int b_end = min(b_begin + item_tiles * kBRows, b_last);

    for (int e = tid; e < NV * kQRows; e += kSweepThreads) {
      const int v = e / kQRows, r = e % kQRows;
      PackedRow<NB> row{};
      if (m0 + r < mq)
        row = load_row<NB>(qbits + (static_cast<size_t>(v) * mq + m0 + r) * NB);
      store_row<NB>(s_q + v * S::kPanels * kPanelQ, kQRows, r, row);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int i0 = s_qidx[r0], i1 = s_qidx[r1];
    const int ql0 = s_qlow[r0], ql1 = s_qlow[r1];
    uint8_t* out0 = out + static_cast<size_t>(m0 + r0) * stride + 4 * quad;
    uint8_t* out1 = out + static_cast<size_t>(m0 + r1) * stride + 4 * quad;
    sweep_base_tiles<NV, NB>(
        s_q, my_b, my_blow, base, blow, b_begin, b_end, group, t, [&](int (&best)[64], int b0) {
          uint32_t w0 = 0, w1 = 0;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = 8 * i + cq + e;
              const int j = b0 + jj;
              const int bl = my_blow[jj];
              const bool jin = j < n_total;
              const uint32_t p0 =
                  (best[4 * i + e] >= ((ql0 | bl) ? nbits : need_ok)) & (j > i0) & jin;
              const uint32_t p1 =
                  (best[4 * i + 2 + e] >= ((ql1 | bl) ? nbits : need_ok)) & (j > i1) & jin;
              w0 |= p0 << (2 * i + e);
              w1 |= p1 << (2 * i + e);
            }
          }
          const uint32_t m0w = pack_quad(w0, quad), m1w = pack_quad(w1, quad);
          if (m0w) *reinterpret_cast<uint32_t*>(out0 + b0 / 8) = m0w;
          if (m1w) *reinterpret_cast<uint32_t*>(out1 + b0 / 8) = m1w;
        });
  }
}

template <int NV, int NB>
int launch_extract(int grid, cudaStream_t st, const void* qbits, const void* base,
                   const void* qlow, const void* blow, const void* qidx, int mq, int npad,
                   int n_total, int sim, int item_tiles, int runs_per_tile, int n_items,
                   void* next_item, void* out) {
  constexpr int smem = sweep_smem_bytes<NV, NB>();
  auto kernel = hamming_extract_kernel<NV, NB>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kSweepThreads, smem, st>>>(
      static_cast<const uint8_t*>(qbits), static_cast<const uint8_t*>(base),
      static_cast<const int32_t*>(qlow), static_cast<const int32_t*>(blow),
      static_cast<const int32_t*>(qidx), mq, npad, n_total, sim, item_tiles, runs_per_tile,
      n_items, static_cast<int*>(next_item), static_cast<uint8_t*>(out));
  return 0;
}

}  // namespace

// nbytes: 32 (PDQ) or 8 (pHash); nv: 1 or 8.  items: (n_items, 4) int32
// {q0, b_begin, b_end, 0} from sweep_items; next_item: one zeroed int.
extern "C" int rupp_hamming_rowcount(const void* packed, const void* low, const void* items,
                                     int n_items, void* next_item, int nv, int nbytes,
                                     int npad, int n_total, int sim, void* counts,
                                     void* stream) {
  if (npad % kBRows != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_items > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int grid = n_items < sms ? n_items : sms;
    int err = 0;
    switch (nv * 100 + nbytes) {
      case 132: err = launch_rowcount<1, 32>(grid, st, packed, low, items, n_items, next_item, npad, n_total, sim, counts); break;
      case 832: err = launch_rowcount<8, 32>(grid, st, packed, low, items, n_items, next_item, npad, n_total, sim, counts); break;
      case 108: err = launch_rowcount<1, 8>(grid, st, packed, low, items, n_items, next_item, npad, n_total, sim, counts); break;
      case 808: err = launch_rowcount<8, 8>(grid, st, packed, low, items, n_items, next_item, npad, n_total, sim, counts); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// out: (mq, npad / 8) u8, zeroed by the caller; npad a multiple of 128;
// item_tiles: base tiles per work item; next_item: one zeroed int.  A
// nonzero row's word is written only by the one tile that computes it.
extern "C" int rupp_hamming_extract(const void* qbits, const void* base, const void* qlow,
                                    const void* blow, const void* qidx, int nv, int nbytes,
                                    int mq, int npad, int n_total, int sim, int item_tiles,
                                    void* next_item, void* out, void* stream) {
  if (npad % kBRows != 0 || item_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_live = n_total < npad ? n_total : npad;
  const int b_tiles = n_live > 0 ? (n_live + kBRows - 1) / kBRows : 0;
  const int runs_per_tile = (b_tiles + item_tiles - 1) / item_tiles;
  const int n_items = (mq + kQRows - 1) / kQRows * runs_per_tile;
  const auto st = static_cast<cudaStream_t>(stream);
  if (mq > 0 && n_items > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int grid = n_items < sms ? n_items : sms;
    int err = 0;
    switch (nv * 100 + nbytes) {
      case 132: err = launch_extract<1, 32>(grid, st, qbits, base, qlow, blow, qidx, mq, npad, n_total, sim, item_tiles, runs_per_tile, n_items, next_item, out); break;
      case 832: err = launch_extract<8, 32>(grid, st, qbits, base, qlow, blow, qidx, mq, npad, n_total, sim, item_tiles, runs_per_tile, n_items, next_item, out); break;
      case 108: err = launch_extract<1, 8>(grid, st, qbits, base, qlow, blow, qidx, mq, npad, n_total, sim, item_tiles, runs_per_tile, n_items, next_item, out); break;
      case 808: err = launch_extract<8, 8>(grid, st, qbits, base, qlow, blow, qidx, mq, npad, n_total, sim, item_tiles, runs_per_tile, n_items, next_item, out); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
