// Streaming luma/box-resample sink shared by the fused probe decoders
// (ruppjpeg.cpp, ruppng.cpp).
//
// Full-resolution luma rows are fed in order; output is (nh, nw) u8,
// bit-identical to ruppnative.cpp box_resample_u8 run on the full
// luma image: same float64 weights (axis_weights), same FP-addition
// order (each output row's source window is an ascending contiguous
// range, and rows arrive ascending), same final floor(x+0.5) clamp.
// Identity dims short-circuit to row copies — prepare_luma_fast never
// resamples <=512px images, and multiplying/dividing by 1.0 is exact
// anyway (verified by the differential tests either way).
//
// Compile with -ffp-contract=off: FMA contraction would change the
// float64 rounding vs the golden (built without FMA on baseline
// x86-64).  Element-wise loops auto-vectorize order-preserving; gcc
// leaves the cols-pass reduction scalar without -fassociative-math.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace ruppstream {

// Identical to ruppnative.cpp axis_weights (same doubles, same order).
inline void axis_weights(int src, int dst, std::vector<int>& starts,
                         std::vector<std::vector<double>>& weights) {
    const double s = (double)src / (double)dst;
    starts.resize(dst);
    weights.resize(dst);
    for (int i = 0; i < dst; i++) {
        double lo = i * s, hi = (i + 1) * s;
        int k0 = (int)std::floor(lo);
        int k1 = std::min((int)std::ceil(hi), src);
        starts[i] = k0;
        auto& w = weights[i];
        w.resize(k1 - k0);
        for (int k = k0; k < k1; k++)
            w[k - k0] =
                std::min(hi, (double)(k + 1)) - std::max(lo, (double)k);
    }
}

// Rec.601 integer luma, identical to ruppnative.cpp luma601.
inline uint8_t luma601_px(const uint8_t* p) {
    return (uint8_t)((299u * p[0] + 587u * p[1] + 114u * p[2] + 500u) /
                     1000u);
}

inline void luma601_row(const uint8_t* px, int w, int stride,
                        uint8_t* out) {
    for (int j = 0; j < w; j++)
        out[j] = luma601_px(px + (size_t)j * stride);
}

struct StreamResampler {
    int w = 0, h = 0, nw = 0, nh = 0;
    bool identity = false;
    int fed = 0;        // source rows consumed
    int next_emit = 0;  // first output row not yet finalized
    uint8_t* out = nullptr;
    std::vector<int> rstarts, cstarts;
    std::vector<std::vector<double>> rwts, cwts;
    std::vector<double> rwsum, cwsum, acc;

    void init(int w_, int h_, int nw_, int nh_, uint8_t* out_) {
        w = w_; h = h_; nw = nw_; nh = nh_; out = out_;
        fed = 0; next_emit = 0;
        identity = (nw == w && nh == h);
        if (identity) return;
        axis_weights(h, nh, rstarts, rwts);
        axis_weights(w, nw, cstarts, cwts);
        rwsum.resize(nh);
        cwsum.resize(nw);
        for (int i = 0; i < nh; i++) {
            double s = 0;
            for (double x : rwts[i]) s += x;
            rwsum[i] = s;
        }
        for (int j = 0; j < nw; j++) {
            double s = 0;
            for (double x : cwts[j]) s += x;
            cwsum[j] = s;
        }
        acc.assign((size_t)nh * w, 0.0);
    }

    // Feed the next full-res luma row (rows must arrive in order).
    void feed(const uint8_t* lp) {
        const int r = fed++;
        if (identity) {
            std::memcpy(out + (size_t)r * w, lp, (size_t)w);
            next_emit = r + 1;
            return;
        }
        // scatter into every open output row; windows are ascending,
        // so per-output-row addition order matches box_resample_u8's
        // ascending-k rows pass
        for (int i = next_emit; i < nh; i++) {
            const int k0 = rstarts[i];
            if (r < k0) break;
            const int kn = (int)rwts[i].size();
            if (r >= k0 + kn) continue;
            const double wk = rwts[i][r - k0];
            double* arow = &acc[(size_t)i * w];
            for (int j = 0; j < w; j++) arow[j] += wk * (double)lp[j];
        }
        // finalize output rows whose source window just closed
        while (next_emit < nh &&
               r + 1 >= rstarts[next_emit] +
                            (int)rwts[next_emit].size()) {
            double* arow = &acc[(size_t)next_emit * w];
            const double inv = rwsum[next_emit];
            for (int j = 0; j < w; j++) arow[j] /= inv;
            uint8_t* orow = out + (size_t)next_emit * nw;
            for (int j = 0; j < nw; j++) {
                const auto& wv = cwts[j];
                const double* p = arow + cstarts[j];
                double v = 0;
                for (size_t k = 0; k < wv.size(); k++)
                    v += p[k] * wv[k];
                v /= cwsum[j];
                double rv = std::floor(v + 0.5);
                orow[j] = (uint8_t)std::max(0.0, std::min(255.0, rv));
            }
            next_emit++;
        }
    }

    bool complete() const { return fed == h && next_emit == nh; }
};

}  // namespace ruppstream
