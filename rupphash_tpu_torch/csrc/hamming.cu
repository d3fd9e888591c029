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
// The base side is variant slot 0 only.  The TPU kernels computed the
// same test as a +/-1 int8 matmul (dot = nbits - 2d, threshold
// dot >= nbits - 2 sim); here the hashes stay packed, NW u32 words per
// hash: 8 for 256-bit PDQ, 2 for 64-bit pHash.  The (V, Npad, nbytes)
// u8 tensor of the public functions is read in place as
// (V, Npad, NW) u32.
//
// What bounds it on this card: each pair costs V x NW XOR + popcount,
// and the SM issues popcount at a quarter of its integer rate, so the
// sweep is bounded by integer issue, not by memory: a 1024-row base
// tile is at most 32 KB of shared memory and serves 128 query rows.
// K6 (hamming_mma.cu) is the int8 tensor-core form of the same count.
//
// K3 layout: block (bj, qi) = 128 query rows (one per thread, its V
// variants in registers) x 1024 base rows (staged in shared memory).
// Tiles wholly at or below the diagonal exit at once.  Row counts are
// summed over base tiles with integer atomicAdd, exact in any order.
//
// K4 layout: each thread owns one output byte, i.e. 8 base rows held in
// registers; a block stages 32 hot query rows in shared memory and
// writes their bytes row by row, so neighbouring threads store
// neighbouring bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 128;    // K3: query rows per block
constexpr int kBaseTile = 1024;     // K3: base rows per block (npad % kBaseTile == 0)
constexpr int kExtractThreads = 128;
constexpr int kExtractQueries = 32;

// One hash as NW words in registers; loads are 16 bytes (NW % 4 == 0)
// or 8 bytes wide, so every hash row must be aligned to its size.
template <int NW>
struct Hash {
  uint32_t w[NW];
};

template <int NW>
__device__ __forceinline__ Hash<NW> load_hash(const uint32_t* p) {
  Hash<NW> h;
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NW / 4; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      h.w[4 * k] = v.x;
      h.w[4 * k + 1] = v.y;
      h.w[4 * k + 2] = v.z;
      h.w[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[k];
      h.w[2 * k] = v.x;
      h.w[2 * k + 1] = v.y;
    }
  }
  return h;
}

template <int NW>
__device__ __forceinline__ int hamming(const Hash<NW>& a, const Hash<NW>& b) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) d += __popc(a.w[k] ^ b.w[k]);
  return d;
}

template <int NV, int NW>
__global__ void __launch_bounds__(kRowThreads)
hamming_rowcount_kernel(const uint32_t* __restrict__ words,  // (NV, npad, NW)
                        const int32_t* __restrict__ low,     // (npad,)
                        int npad, int n_total, int sim,
                        int32_t* __restrict__ counts) {      // (npad,), zeroed
  const int q0 = blockIdx.y * kRowThreads;
  const int b0 = blockIdx.x * kBaseTile;
  if (b0 + kBaseTile - 1 <= q0 || b0 >= n_total || q0 >= n_total) return;

  __shared__ __align__(16) uint32_t s_base[kBaseTile * NW];
  __shared__ int32_t s_low[kBaseTile];
  const uint2* src = reinterpret_cast<const uint2*>(words + static_cast<size_t>(b0) * NW);
  uint2* dst = reinterpret_cast<uint2*>(s_base);
  for (int e = threadIdx.x; e < kBaseTile * NW / 2; e += kRowThreads) dst[e] = src[e];
  for (int e = threadIdx.x; e < kBaseTile; e += kRowThreads) s_low[e] = low[b0 + e];
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i >= n_total) return;
  Hash<NW> q[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v)
    q[v] = load_hash<NW>(words + (static_cast<size_t>(v) * npad + i) * NW);
  const int qlow = low[i];
  const int jlo = max(b0, i + 1) - b0;
  const int jhi = min(b0 + kBaseTile, n_total) - b0;
  int cnt = 0;
  for (int jj = jlo; jj < jhi; ++jj) {
    const Hash<NW> b = load_hash<NW>(s_base + jj * NW);
    int dmin = 32 * NW;
#pragma unroll
    for (int v = 0; v < NV; ++v) dmin = min(dmin, hamming<NW>(q[v], b));
    const int thr = (qlow | s_low[jj]) ? 0 : sim;
    cnt += dmin <= thr;
  }
  if (cnt) atomicAdd(counts + i, cnt);
}

template <int NV, int NW>
__global__ void __launch_bounds__(kExtractThreads)
hamming_extract_kernel(const uint32_t* __restrict__ qwords,  // (NV, mq, NW)
                       const uint32_t* __restrict__ bwords,  // (npad, NW)
                       const int32_t* __restrict__ qlow,     // (mq,)
                       const int32_t* __restrict__ blow,     // (npad,)
                       const int32_t* __restrict__ qidx,     // (mq,)
                       int mq, int npad, int n_total, int sim,
                       uint8_t* __restrict__ out) {          // (mq, npad / 8)
  __shared__ __align__(16) uint32_t s_q[kExtractQueries][NV][NW];
  __shared__ int32_t s_qlow[kExtractQueries];
  __shared__ int32_t s_qidx[kExtractQueries];
  const int m0 = blockIdx.y * kExtractQueries;
  for (int e = threadIdx.x; e < kExtractQueries * NV * NW; e += kExtractThreads) {
    const int m = e / (NV * NW), v = (e / NW) % NV, k = e % NW;
    s_q[m][v][k] = (m0 + m < mq) ? qwords[(static_cast<size_t>(v) * mq + m0 + m) * NW + k] : 0u;
  }
  for (int e = threadIdx.x; e < kExtractQueries; e += kExtractThreads) {
    s_qlow[e] = (m0 + e < mq) ? qlow[m0 + e] : 1;
    s_qidx[e] = (m0 + e < mq) ? qidx[m0 + e] : n_total;
  }
  __syncthreads();

  const int stride = npad / 8;
  const int col = blockIdx.x * kExtractThreads + threadIdx.x;
  if (col >= stride) return;
  const int j0 = col * 8;
  Hash<NW> b[8];
  int blow_bits = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    b[r] = load_hash<NW>(bwords + static_cast<size_t>(j0 + r) * NW);
    blow_bits |= (blow[j0 + r] != 0) << r;
  }
  const int mend = min(kExtractQueries, mq - m0);
  for (int m = 0; m < mend; ++m) {
    int dmin[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) dmin[r] = 32 * NW;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const Hash<NW> a = load_hash<NW>(s_q[m][v]);
#pragma unroll
      for (int r = 0; r < 8; ++r) dmin[r] = min(dmin[r], hamming<NW>(a, b[r]));
    }
    const int qi = s_qidx[m];
    const bool ql = s_qlow[m] != 0;
    unsigned byte = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = j0 + r;
      const int thr = (ql || ((blow_bits >> r) & 1)) ? 0 : sim;
      const bool bit = dmin[r] <= thr && j > qi && j < n_total && qi < n_total;
      byte |= static_cast<unsigned>(bit) << r;
    }
    out[static_cast<size_t>(m0 + m) * stride + col] = static_cast<uint8_t>(byte);
  }
}

template <int NV, int NW>
void launch_rowcount(dim3 grid, cudaStream_t st, const void* words, const void* low, int npad,
                     int n_total, int sim, void* counts) {
  hamming_rowcount_kernel<NV, NW><<<grid, kRowThreads, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(low), npad, n_total, sim,
      static_cast<int32_t*>(counts));
}

template <int NV, int NW>
void launch_extract(dim3 grid, cudaStream_t st, const void* qwords, const void* bwords,
                    const void* qlow, const void* blow, const void* qidx, int mq, int npad,
                    int n_total, int sim, void* out) {
  hamming_extract_kernel<NV, NW><<<grid, kExtractThreads, 0, st>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(bwords),
      static_cast<const int32_t*>(qlow), static_cast<const int32_t*>(blow),
      static_cast<const int32_t*>(qidx), mq, npad, n_total, sim, static_cast<uint8_t*>(out));
}

}  // namespace

// nbytes: 32 (PDQ, 8 words) or 8 (pHash, 2 words); nv: 1 or 8.
extern "C" int rupp_hamming_rowcount(const void* words, const void* low, int nv, int nbytes,
                                     int npad, int n_total, int sim, void* counts,
                                     void* stream) {
  if (npad % kBaseTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(npad / kBaseTile, npad / kRowThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  if (npad > 0) {
    const int key = nv * 100 + nbytes;
    switch (key) {
      case 132: launch_rowcount<1, 8>(grid, st, words, low, npad, n_total, sim, counts); break;
      case 832: launch_rowcount<8, 8>(grid, st, words, low, npad, n_total, sim, counts); break;
      case 108: launch_rowcount<1, 2>(grid, st, words, low, npad, n_total, sim, counts); break;
      case 808: launch_rowcount<8, 2>(grid, st, words, low, npad, n_total, sim, counts); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rupp_hamming_extract(const void* qwords, const void* bwords, const void* qlow,
                                    const void* blow, const void* qidx, int nv, int nbytes,
                                    int mq, int npad, int n_total, int sim, void* out,
                                    void* stream) {
  if (npad % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int stride = npad / 8;
  const dim3 grid((stride + kExtractThreads - 1) / kExtractThreads,
                  (mq + kExtractQueries - 1) / kExtractQueries);
  const auto st = static_cast<cudaStream_t>(stream);
  if (mq > 0 && stride > 0) {
    const int key = nv * 100 + nbytes;
    switch (key) {
      case 132: launch_extract<1, 8>(grid, st, qwords, bwords, qlow, blow, qidx, mq, npad, n_total, sim, out); break;
      case 832: launch_extract<8, 8>(grid, st, qwords, bwords, qlow, blow, qidx, mq, npad, n_total, sim, out); break;
      case 108: launch_extract<1, 2>(grid, st, qwords, bwords, qlow, blow, qidx, mq, npad, n_total, sim, out); break;
      case 808: launch_extract<8, 2>(grid, st, qwords, bwords, qlow, blow, qidx, mq, npad, n_total, sim, out); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
