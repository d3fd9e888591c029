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
// bit for bit.  K6 stays on the warp-level mma.sync.m16n8k32 on
// purpose: K3 runs on wgmma, and an independent instruction, tile walk
// and staging make K6 the cross-check of K3 at sizes where no plain
// version can run.
//
// What bounds it on this card: 2 * nbits int8 operations per pair and
// variant, 2.0e13 at N=100k, V=8 (10.3 ms at the 1,979 TOP/s int8 peak).
// mma.sync reaches about two thirds of that peak from registers alone
// (6.5e14 products/s measured, probes/b1_rate_probe.cu), so 15.7 ms, a
// share of 0.66, is this instruction's ceiling, not the design's.
//
// What the design does about it:
//  - The reuse follows the sizes.  The base side (variant slot 0) is
//    the small one, so each warp keeps the B fragments of its 64 base
//    rows (matrix columns) in registers for the whole depth (128
//    registers a lane at 256 bits) and the query rows of all variants
//    stream past them.  One ldmatrix.x4 (512 bytes of shared memory)
//    then feeds 8 MMAs, and B costs nothing in the inner loop.
//  - A block of 8 warps covers 512 columns and shares one query stream:
//    stages of 128 shared-memory rows (16 query rows x 8 variants, or
//    128 rows x 1) arrive by 16-byte cp.async in a ring of 6 buffers,
//    requested 3 stages ahead; rows are padded by 16 bytes so the 8 rows
//    of an ldmatrix phase fall in 8 different 16-byte bank groups.
//  - No block-wide barrier inside an item.  Each buffer has two
//    mbarriers: `full` collects one arrival a thread when that thread's
//    copies of the stage have landed (cp.async.mbarrier.arrive), `empty`
//    one a warp when the warp has read the stage.  A warp waits for
//    `full` before it reads and for `empty` of the buffer it is about to
//    refill, which held the stage three back, so warps drift up to two
//    stages apart instead of meeting at every stage.
//  - Only the triangle is walked: persistent blocks take (column block,
//    query run) items from a counter.  The host lists them run-major, so
//    the blocks in flight stream the same query rows and share them in
//    L2 (ops/hamming_cuda.py::pm1_sweep_items).  A warp skips the query
//    tiles wholly on or below its columns' diagonal.
//  - The per-pair maximum over the variants stays in registers (a pair
//    that matches under several variants counts once).  Matches are
//    rare, so a warp first votes on the largest dot of the whole tile
//    (16 three-input maxima a lane) and runs the predicate, about 200
//    instructions a lane, only for a tile that reached the threshold.
//    Counts leave by integer atomicAdd of the lanes that saw a match.
//
// Fragment layout (PTX, m16n8k32 s8): lane = 4 g + t.  A: a0 row g,
// bytes 4t..4t+3; a1 row g + 8; a2, a3 the same at bytes 16 + 4t: what
// ldmatrix.x4 returns for the four 8 x 16-byte matrices (rows 0-7 and
// 8-15, bytes 0-15 and 16-31).  B: b0 column g, bytes 4t..4t+3; b1
// bytes 16 + 4t.  C: c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 8;                      // n8 tiles (of 8 columns) a warp
constexpr int kWarpCols = 8 * kNT;          // 64
constexpr int kBlockCols = kWarps * kWarpCols;  // 512 = PM1_COLS
constexpr int kStageRows = 128;             // shared-memory rows a stage
constexpr int kStages = 6;                  // stage buffers in shared memory
constexpr int kAhead = 3;                   // stages requested ahead of the one in work

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1, int c0, int c1, int c2, int c3) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// The barrier at `bar` gets one arrival when this thread's cp.async
// copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One variant's dots of a 16-row query tile against the warp's columns:
// acc = A . B over the whole depth.  a_cur holds the A fragment of the
// first step on entry and that of `next_slot` on return; each step's
// ldmatrix goes out one step ahead of the MMAs that use it.
template <int KB>
__device__ __forceinline__ void variant_dots(int (&acc)[kNT][4], uint32_t (&a_cur)[4],
                                             const uint32_t (&b)[kNT][KB / 32][2],
                                             uint32_t slot, uint32_t next_slot) {
  constexpr int kSteps = KB / 32;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    uint32_t a_nxt[4];
    ldmatrix_x4(a_nxt, s + 1 < kSteps ? slot + (s + 1) * 32 : next_slot);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (s == 0)
        mma_s8(acc[nt], a_cur, b[nt][s][0], b[nt][s][1], 0, 0, 0, 0);
      else
        mma_s8(acc[nt], a_cur, b[nt][s][0], b[nt][s][1], acc[nt][0], acc[nt][1], acc[nt][2],
               acc[nt][3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) a_cur[c] = a_nxt[c];
  }
}

// The largest of a lane's 4 * kNT results, by 3-input maxima.
__device__ __forceinline__ int lane_max(const int (&acc)[kNT][4]) {
  int m = INT_MIN;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    m = __vimax3_s32(m, __vimax3_s32(acc[nt][0], acc[nt][1], acc[nt][2]), acc[nt][3]);
  return m;
}

// Shared-memory bytes of one stage: kStageRows padded rows, then the low
// flags of the stage's query rows (16 or 128 ints, room for 128).
template <int KB>
__host__ __device__ constexpr int stage_bytes() { return kStageRows * (KB + 16) + kStageRows * 4; }

// KB: bytes (= bits) per +/-1 row, 256 (PDQ) or 64 (pHash); NV: 1 or 8.
template <int NV, int KB>
__global__ void __launch_bounds__(kThreads, 1)
hamming_rowcount_mma_kernel(const int8_t* __restrict__ pm1,   // (NV, npad, KB)
                            const int32_t* __restrict__ low,  // (npad,)
                            const int4* __restrict__ items,   // [c0, q_begin, q_end, 0]
                            int n_items, int* __restrict__ next_item,
                            int npad, int n_total, int sim,
                            int32_t* __restrict__ counts) {   // (npad,), zeroed
  constexpr int kPitch = KB + 16;
  constexpr int kTiles = kStageRows / 16 / NV;  // 16-row query tiles a stage: 1 or 8
  constexpr int kQRows = 16 * kTiles;         // query rows a stage
  constexpr int kChunks = KB / 16;            // 16-byte pieces a row
  constexpr int kStage = stage_bytes<KB>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  __shared__ __align__(8) uint64_t s_full[kStages], s_empty[kStages];

  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = min(n_total, npad);
  const int thr = KB - 2 * sim;
  // this lane's row address inside a 16-row slot, for ldmatrix.x4
  const uint32_t lane_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + (lane >> 4) * 16;

  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(s_full));
  const uint32_t empty = static_cast<uint32_t>(__cvta_generic_to_shared(s_empty));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kThreads);
      mbar_init(empty + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int g0 = 0;  // stages this block has been through: buffers and phases follow it

  for (;;) {
    __syncthreads();  // the previous item's stages are consumed, s_item is read
    if (threadIdx.x == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;
    const int4 it = items[item];
    const int w0 = it.x + warp * kWarpCols;   // this warp's first column
    const int n_stages = (it.z - it.y) / kQRows;

    // every thread requests its 16-byte pieces of stage k, once every warp
    // has left the buffer's previous stage
    auto load_stage = [&](int k) {
      const int gk = g0 + k, buf = gk % kStages;
      if (gk >= kStages) mbar_wait(empty + 8 * buf, (gk / kStages - 1) & 1);
      const int q = it.y + k * kQRows;
      const uint32_t dst = sbase + buf * kStage;
      for (int e = threadIdx.x; e < kStageRows * kChunks; e += kThreads) {
        const int srow = e / kChunks, c = e % kChunks;
        const size_t grow = NV == 1 ? static_cast<size_t>(q + srow)
                                    : static_cast<size_t>(srow >> 4) * npad + q + (srow & 15);
        cp_async16(dst + srow * kPitch + c * 16, pm1 + grow * KB + c * 16);
      }
      if (threadIdx.x < kQRows / 4)
        cp_async16(dst + kStageRows * kPitch + threadIdx.x * 16, low + q + threadIdx.x * 4);
      cp_async_arrive(full + 8 * buf);
    };

    for (int k = 0; k < kAhead && k < n_stages; ++k) load_stage(k);

    // this warp's base rows, for the whole depth, and their low flags
    uint32_t b[kNT][KB / 32][2];
    uint32_t blow = 0;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = min(w0 + nt * 8 + g, npad - 1);
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(pm1 + static_cast<size_t>(col) * KB) + t;
#pragma unroll
      for (int s = 0; s < KB / 32; ++s) {
        b[nt][s][0] = __ldg(src + s * 8);
        b[nt][s][1] = __ldg(src + s * 8 + 4);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (__ldg(low + min(w0 + nt * 8 + 2 * t + e, npad - 1))) blow |= 1u << (nt * 2 + e);
    }

    for (int k = 0; k < n_stages; ++k) {
      if (k + kAhead < n_stages) load_stage(k + kAhead);
      const int gk = g0 + k, buf = gk % kStages;
      mbar_wait(full + 8 * buf, (gk / kStages) & 1);  // stage k has landed

      const uint32_t stage = sbase + buf * kStage;
      const int32_t* s_low =
          reinterpret_cast<const int32_t*>(smem + buf * kStage + kStageRows * kPitch);
#pragma unroll 1
      for (int tile = 0; tile < kTiles; ++tile) {
        const int q0 = it.y + k * kQRows + tile * 16;
        // every i of the tile at or past every j of the warp, or no live row
        if (q0 >= w0 + kWarpCols - 1 || w0 >= n || q0 >= n) continue;

        const uint32_t slot0 = stage + tile * NV * 16 * kPitch + lane_off;
        uint32_t a_cur[4];

        // per pair, the largest dot over the variants: the first variant's
        // dots start it, the others fold in
        int best[kNT][4];
        ldmatrix_x4(a_cur, slot0);
        variant_dots<KB>(best, a_cur, b, slot0, slot0 + (NV > 1 ? 16 * kPitch : 0));
#pragma unroll 1
        for (int v = 1; v < NV; ++v) {
          const uint32_t slot = slot0 + v * 16 * kPitch;
          int acc[kNT][4];
          variant_dots<KB>(acc, a_cur, b, slot, v + 1 < NV ? slot + 16 * kPitch : slot0);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) best[nt][c] = max(best[nt][c], acc[nt][c]);
        }
        // matches are rare: most tiles end here, after 16 instructions
        if (!__any_sync(0xffffffffu, lane_max(best) >= thr)) continue;

        // accumulator (nt, c): row q0 + g for c < 2, q0 + g + 8 otherwise;
        // column w0 + nt * 8 + 2t + (c & 1)
        const int i0 = q0 + g, i1 = i0 + 8;
        const int need0 = s_low[tile * 16 + g] ? KB : thr;
        const int need1 = s_low[tile * 16 + g + 8] ? KB : thr;
        int cnt0 = 0, cnt1 = 0;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = w0 + nt * 8 + 2 * t + (c & 1);
            const int i = c < 2 ? i0 : i1;
            const bool lj = blow & (1u << (nt * 2 + (c & 1)));
            const int need = lj ? KB : (c < 2 ? need0 : need1);
            const int hit = best[nt][c] >= need && j > i && j < n;
            if (c < 2) cnt0 += hit; else cnt1 += hit;
          }
        if (cnt0) atomicAdd(counts + i0, cnt0);
        if (cnt1) atomicAdd(counts + i1, cnt1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * buf);  // this warp has left stage k
    }
    g0 += n_stages;
  }
}

template <int NV, int KB>
cudaError_t launch(cudaStream_t st, const void* pm1, const void* low, const void* items,
                   int n_items, void* next_item, int npad, int n_total, int sim, void* counts) {
  constexpr int kSmem = kStages * stage_bytes<KB>();
  auto kern = hamming_rowcount_mma_kernel<NV, KB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = n_items < sms ? n_items : sms;
  kern<<<blocks, kThreads, kSmem, st>>>(
      static_cast<const int8_t*>(pm1), static_cast<const int32_t*>(low),
      static_cast<const int4*>(items), n_items, static_cast<int*>(next_item), npad, n_total,
      sim, static_cast<int32_t*>(counts));
  return cudaGetLastError();
}

}  // namespace

// nbits: 256 or 64; nv: 1 or 8.  items: (n_items, 4) int32 rows
// [c0, q_begin, q_end, 0] with c0 a multiple of 512 and the query rows a
// multiple of 128 (ops/hamming_cuda.py::pm1_sweep_items); next_item: one
// zeroed int32; counts zeroed.
extern "C" int rupp_hamming_rowcount_mma(const void* pm1, const void* low, const void* items,
                                         int n_items, void* next_item, int nv, int nbits,
                                         int npad, int n_total, int sim, void* counts,
                                         void* stream) {
  if (npad <= 0 || npad % kBlockCols != 0 || n_items < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (nv * 1000 + nbits) {
    case 1256: err = launch<1, 256>(st, pm1, low, items, n_items, next_item, npad, n_total, sim, counts); break;
    case 8256: err = launch<8, 256>(st, pm1, low, items, n_items, next_item, npad, n_total, sim, counts); break;
    case 1064: err = launch<1, 64>(st, pm1, low, items, n_items, next_item, npad, n_total, sim, counts); break;
    case 8064: err = launch<8, 64>(st, pm1, low, items, n_items, next_item, npad, n_total, sim, counts); break;
    default: break;
  }
  return static_cast<int>(err);
}
