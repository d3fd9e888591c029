// The back half of a PDQ hash, shared by K1 (pdq.cu) and K2
// (pdq_coeffs.cu): from one image's 64 x 64 buffer in shared memory to
// its quality, its 16 x 16 DCT coefficients and its eight dihedral
// hashes.
//
//   quality = min(sum trunc(|d| * 100 / 255) / 90, 1) over neighbours
//   coeffs  = D16 . buf64 . D16^T        (16, 16), fp32 FMA in index order
//   4 sign patterns -> lower median (128th smallest) by a bitonic sort
//   -> bits -> 8 dihedral variants packed as bytes (byte 31 - idx/8,
//   bit idx%8; transposed variants read bit c*16+r for output r*16+c).
//
// NT threads (128 or 256) that synchronise through `sync` run it
// together: a thread block with __syncthreads, or one warpgroup with its
// named barrier.  Every output's sum runs in the same order whatever NT
// is, so both kernels give the same bits from the same buffer.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pdq_epilogue {

constexpr int kTile = 64;          // buffer64 side
constexpr int kPad = kTile + 4;    // row pitch of buffer64
// scratch: bd (64 x 16), the four sign variants (sorted in place), D16
// transposed, all f32; then the bits
constexpr int kScratchBytes = (kTile * 16 + 4 * 256 + kTile * 16) * 4 + 4 * 256;

__device__ __forceinline__ int quality_term(float a, float b) {
  const float d = __fsub_rn(a, b);
  return static_cast<int>(truncf(fabsf(__fdiv_rn(__fmul_rn(d, 100.0f), 255.0f))));
}

// buf: buffer64 [64][kPad], complete and visible to the NT threads;
// scratch: kScratchBytes, 16-byte aligned; *s_qsum zero and visible;
// s_med: four floats.  Writes quality[0], coeffs[0..256) and, unless
// dihedral is null, dihedral[0..8 * 32).  Ends without a barrier: the
// caller synchronises before it reuses buf, scratch, s_qsum or s_med.
template <int NT, class Sync>
__device__ __forceinline__ void finish_image(int t, const float* buf, uint8_t* scratch,
                                             int* s_qsum, float* s_med,
                                             const float* __restrict__ d16,
                                             uint8_t* __restrict__ dihedral,
                                             float* __restrict__ quality,
                                             float* __restrict__ coeffs, Sync sync) {
  static_assert(NT == 128 || NT == 256, "one warpgroup or one block of 256");
  constexpr int kOwn = 256 / NT;   // coefficients per thread

  // Quality: every term is a small integer, so the sum is exact in any order.
  int qs = 0;
  for (int e = t; e < (kTile - 1) * kTile; e += NT) {
    const int r = e / kTile, c = e % kTile;   // vertical neighbours
    qs += quality_term(buf[r * kPad + c], buf[(r + 1) * kPad + c]);
    const int r2 = e / (kTile - 1), c2 = e % (kTile - 1);   // horizontal
    qs += quality_term(buf[r2 * kPad + c2], buf[r2 * kPad + c2 + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qs += __shfl_down_sync(0xffffffffu, qs, off);
  if ((t & 31) == 0) atomicAdd(s_qsum, qs);

  float* bd = reinterpret_cast<float*>(scratch);
  float* sv = bd + kTile * 16;
  float* d16t = sv + 4 * 256;
  uint8_t* s_bits = reinterpret_cast<uint8_t*>(d16t + kTile * 16);
  for (int e = t; e < kTile * 16; e += NT) d16t[e] = d16[(e % 16) * kTile + e / 16];
  sync();

  // bd[p][c] = sum_q buffer64[p][q] * D16[c][q], q ascending; an owner
  // takes row p = o / 4 and columns c0 .. c0 + 3 (four chains).
  for (int o = t; o < 256; o += NT) {
    const int p = o >> 2, c0 = (o & 3) * 4;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
    for (int q = 0; q < kTile; ++q) {
      const float b = buf[p * kPad + q];
      const float4 d = *reinterpret_cast<const float4*>(d16t + q * 16 + c0);
      a0 = fmaf(b, d.x, a0);
      a1 = fmaf(b, d.y, a1);
      a2 = fmaf(b, d.z, a2);
      a3 = fmaf(b, d.w, a3);
    }
    *reinterpret_cast<float4*>(bd + p * 16 + c0) = make_float4(a0, a1, a2, a3);
  }
  sync();
  if (t == 0) quality[0] = fminf(__fdiv_rn(static_cast<float>(*s_qsum), 90.0f), 1.0f);

  // coeffs[r][c] = sum_p D16[r][p] * bd[p][c], p ascending; the owner of
  // idx = r*16+c.  Sign variants [identity, neg cols, neg rows, neg
  // both]: a mirror negates odd DCT frequencies (index + 1), i.e. even
  // indices.
  float4 mine[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int idx = t + k * NT;
    const int r = idx >> 4, c = idx & 15;
    float cf = 0.0f;
#pragma unroll 16
    for (int p = 0; p < kTile; ++p) cf = fmaf(d16t[p * 16 + r], bd[p * 16 + c], cf);
    coeffs[idx] = cf;
    const bool fr = (r & 1) == 0, fc = (c & 1) == 0;
    mine[k] = make_float4(cf, fc ? -cf : cf, fr ? -cf : cf, (fr != fc) ? -cf : cf);
    sv[0 * 256 + idx] = mine[k].x;
    sv[1 * 256 + idx] = mine[k].y;
    sv[2 * 256 + idx] = mine[k].z;
    sv[3 * 256 + idx] = mine[k].w;
  }
  if (dihedral == nullptr) return;
  sync();

  // Lower median of each variant, the 128th smallest value: a bitonic
  // sort of the four variants in place, 128 threads exchanging the
  // pair (i, i ^ j) of each.  Ties may land in either order; equal
  // values (a +0/-0 tie included) give the same bits.
  for (int k = 2; k <= 256; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (t < 128) {
        const int i = 2 * t - (t & (j - 1)), l = i + j;   // i has bit j clear
        const bool up = (i & k) == 0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float a = sv[v * 256 + i], b = sv[v * 256 + l];
          if ((a > b) == up) {
            sv[v * 256 + i] = b;
            sv[v * 256 + l] = a;
          }
        }
      }
      sync();
    }
  }
  if (t < 4) s_med[t] = sv[t * 256 + 127];
  sync();
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int idx = t + k * NT;
    s_bits[0 * 256 + idx] = mine[k].x > s_med[0];
    s_bits[1 * 256 + idx] = mine[k].y > s_med[1];
    s_bits[2 * 256 + idx] = mine[k].z > s_med[2];
    s_bits[3 * 256 + idx] = mine[k].w > s_med[3];
  }
  sync();

  // Dihedral order (sign pattern, transposed): identity, rot90, rot180,
  // rot270, mirror-x, mirror-y, transpose, anti-transpose.
  const int kSign[8] = {0, 2, 3, 1, 1, 2, 0, 3};
  const bool kTrans[8] = {false, true, false, true, false, false, true, true};
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int o = t + k * NT;
    const int v = o >> 5, ob = o & 31;
    const int sgn = kSign[v];
    const bool tr = kTrans[v];
    const int base = 8 * (31 - ob);
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pos = base + j;
      const int src = tr ? ((pos & 15) * 16 + (pos >> 4)) : pos;
      byte |= static_cast<unsigned>(s_bits[sgn * 256 + src]) << j;
    }
    dihedral[o] = static_cast<uint8_t>(byte);
  }
}

}  // namespace pdq_epilogue
