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
// same test as a +/-1 int8 matmul (dot = 256 - 2d, threshold
// dot >= 256 - 2 sim); here the hashes stay packed, 8 x u32 words per
// 256-bit hash: the (V, Npad, 32) u8 tensor of the public functions is
// read in place as (V, Npad, 2) uint4.
//
// What bounds it on this card: each pair costs V x 8 XOR + popcount,
// and the SM issues popcount at a quarter of its integer rate, so the
// sweep is bounded by integer issue, not by memory: a 1024-row base
// tile is 32 KB of shared memory and serves 128 query rows.  Int8 or
// 1-bit tensor-core MMA is the route to a faster sweep, later.
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

__device__ __forceinline__ int hamming256(const uint4& a0, const uint4& a1,
                                          const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

template <int NV>
__global__ void __launch_bounds__(kRowThreads)
hamming_rowcount_kernel(const uint4* __restrict__ words,   // (NV, npad, 2)
                        const int32_t* __restrict__ low,   // (npad,)
                        int npad, int n_total, int sim,
                        int32_t* __restrict__ counts) {    // (npad,), zeroed
  const int q0 = blockIdx.y * kRowThreads;
  const int b0 = blockIdx.x * kBaseTile;
  if (b0 + kBaseTile - 1 <= q0 || b0 >= n_total || q0 >= n_total) return;

  __shared__ uint4 s_base[kBaseTile * 2];
  __shared__ int32_t s_low[kBaseTile];
  for (int e = threadIdx.x; e < kBaseTile * 2; e += kRowThreads)
    s_base[e] = words[static_cast<size_t>(b0) * 2 + e];
  for (int e = threadIdx.x; e < kBaseTile; e += kRowThreads) s_low[e] = low[b0 + e];
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i >= n_total) return;
  uint4 q[NV][2];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    q[v][0] = words[(static_cast<size_t>(v) * npad + i) * 2];
    q[v][1] = words[(static_cast<size_t>(v) * npad + i) * 2 + 1];
  }
  const int qlow = low[i];
  const int jlo = max(b0, i + 1) - b0;
  const int jhi = min(b0 + kBaseTile, n_total) - b0;
  int cnt = 0;
  for (int jj = jlo; jj < jhi; ++jj) {
    const uint4 b_lo = s_base[jj * 2];
    const uint4 b_hi = s_base[jj * 2 + 1];
    int dmin = 256;
#pragma unroll
    for (int v = 0; v < NV; ++v) dmin = min(dmin, hamming256(q[v][0], q[v][1], b_lo, b_hi));
    const int thr = (qlow | s_low[jj]) ? 0 : sim;
    cnt += dmin <= thr;
  }
  if (cnt) atomicAdd(counts + i, cnt);
}

template <int NV>
__global__ void __launch_bounds__(kExtractThreads)
hamming_extract_kernel(const uint4* __restrict__ qwords,   // (NV, mq, 2)
                       const uint4* __restrict__ bwords,   // (npad, 2)
                       const int32_t* __restrict__ qlow,   // (mq,)
                       const int32_t* __restrict__ blow,   // (npad,)
                       const int32_t* __restrict__ qidx,   // (mq,)
                       int mq, int npad, int n_total, int sim,
                       uint8_t* __restrict__ out) {        // (mq, npad / 8)
  __shared__ uint4 s_q[kExtractQueries][NV][2];
  __shared__ int32_t s_qlow[kExtractQueries];
  __shared__ int32_t s_qidx[kExtractQueries];
  const int m0 = blockIdx.y * kExtractQueries;
  for (int e = threadIdx.x; e < kExtractQueries * NV * 2; e += kExtractThreads) {
    const int m = e / (NV * 2), v = (e / 2) % NV, h = e % 2;
    s_q[m][v][h] = (m0 + m < mq) ? qwords[(static_cast<size_t>(v) * mq + m0 + m) * 2 + h]
                                 : make_uint4(0, 0, 0, 0);
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
  uint4 b[8][2];
  int blow_bits = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    b[r][0] = bwords[static_cast<size_t>(j0 + r) * 2];
    b[r][1] = bwords[static_cast<size_t>(j0 + r) * 2 + 1];
    blow_bits |= (blow[j0 + r] != 0) << r;
  }
  const int mend = min(kExtractQueries, mq - m0);
  for (int m = 0; m < mend; ++m) {
    int dmin[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) dmin[r] = 256;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint4 a0 = s_q[m][v][0], a1 = s_q[m][v][1];
#pragma unroll
      for (int r = 0; r < 8; ++r) dmin[r] = min(dmin[r], hamming256(a0, a1, b[r][0], b[r][1]));
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

}  // namespace

extern "C" int rupp_hamming_rowcount(const void* words, const void* low, int nv,
                                     int npad, int n_total, int sim, void* counts,
                                     void* stream) {
  if (npad % kBaseTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(npad / kBaseTile, npad / kRowThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint4*>(words);
  const auto* lo = static_cast<const int32_t*>(low);
  auto* out = static_cast<int32_t*>(counts);
  if (npad > 0) {
    switch (nv) {
      case 1:
        hamming_rowcount_kernel<1><<<grid, kRowThreads, 0, st>>>(w, lo, npad, n_total, sim, out);
        break;
      case 8:
        hamming_rowcount_kernel<8><<<grid, kRowThreads, 0, st>>>(w, lo, npad, n_total, sim, out);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rupp_hamming_extract(const void* qwords, const void* bwords,
                                    const void* qlow, const void* blow,
                                    const void* qidx, int nv, int mq, int npad,
                                    int n_total, int sim, void* out, void* stream) {
  if (npad % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int stride = npad / 8;
  const dim3 grid((stride + kExtractThreads - 1) / kExtractThreads,
                  (mq + kExtractQueries - 1) / kExtractQueries);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const uint4*>(qwords);
  const auto* bw = static_cast<const uint4*>(bwords);
  const auto* ql = static_cast<const int32_t*>(qlow);
  const auto* bl = static_cast<const int32_t*>(blow);
  const auto* qi = static_cast<const int32_t*>(qidx);
  auto* o = static_cast<uint8_t*>(out);
  if (mq > 0 && stride > 0) {
    switch (nv) {
      case 1:
        hamming_extract_kernel<1><<<grid, kExtractThreads, 0, st>>>(q, bw, ql, bl, qi, mq, npad,
                                                                    n_total, sim, o);
        break;
      case 8:
        hamming_extract_kernel<8><<<grid, kExtractThreads, 0, st>>>(q, bw, ql, bl, qi, mq, npad,
                                                                    n_total, sim, o);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
