// Fused WebP -> luma(+box-resample) probe decoder.
//
// Same architectural slot as ruppjpeg.cpp / ruppng.cpp: the scan probe
// needs only (full dims, <=512px luma), so the bitstream decodes once
// through libwebp straight into a packed RGB buffer and rows reduce to
// Rec.601 luma into the shared resample sink (rupp_stream.h) — the PIL
// image object, the RGBA->RGB convert copy, the PIL->numpy copy and
// the separate full-res luma pass never exist.  ~1.5x host throughput
// for 4 MP WebPs on this box.
//
// Bit-exactness: Pillow decodes WebP through the same system libwebp
// (MODE_RGBA via its anim-decoder path); libwebp's RGB and RGBA output
// modes emit identical color samples (same fancy upsampler, no
// dithering in either default config), so WebPDecodeRGBInto + the
// golden luma/resample math reproduces decode_bytes ->
// prepare_luma_fast exactly.  That equivalence is enforced by the
// runtime self-probe corpus (lossy/lossless x alpha/no-alpha, odd
// dims, the resample branch) in native/webpfast.py, and per stream by
// rejecting animation (WebPGetFeatures) and any decode failure —
// rejected streams take the PIL path and inherit its behavior.
//
// Reference parity: the reference full-decodes WebP on the host via
// image-rs before hashing (scanner.rs:716-735 generic path); same
// slot, copies fused away.
//
// Build (native/webpfast.py): g++ -O3 -march=native -ffp-contract=off
//   -shared -fPIC -std=c++17 ruppwebp.cpp -o ruppwebp.so -lwebp

#include <cstdint>
#include <cstring>
#include <vector>

#include <webp/decode.h>

#include "rupp_stream.h"

extern "C" {

// 0 + w/h for a decodable still WebP (lossy VP8, lossless VP8L, or
// VP8X-extended without the animation flag), nonzero otherwise.
int webp_dims(const uint8_t* data, int64_t len, int* w, int* h) {
    WebPBitstreamFeatures f;
    if (WebPGetFeatures(data, (size_t)len, &f) != VP8_STATUS_OK)
        return -1;
    if (f.has_animation) return -2;  // animated.py owns those
    if (f.width <= 0 || f.height <= 0) return -3;
    *w = f.width;
    *h = f.height;
    return 0;
}

static int webp_luma_probe_impl(const uint8_t* data, int64_t len,
                                int nw, int nh, uint8_t* out, int* fw,
                                int* fh) {
    int w, h;
    int rc = webp_dims(data, len, &w, &h);
    if (rc != 0) return rc;
    *fw = w;
    *fh = h;
    if (nw <= 0 || nh <= 0 || nw > w || nh > h) return -4;
    // one full-res RGB plane (alpha dropped like convert("RGB"));
    // libwebp wants the whole buffer up front, rows stream after
    std::vector<uint8_t> rgb((size_t)w * h * 3);
    if (!WebPDecodeRGBInto(data, (size_t)len, rgb.data(), rgb.size(),
                           w * 3))
        return -5;  // truncated/corrupt: Pillow raises too
    ruppstream::StreamResampler rs;
    rs.init(w, h, nw, nh, out);
    std::vector<uint8_t> luma(w);
    for (int y = 0; y < h; y++) {
        ruppstream::luma601_row(rgb.data() + (size_t)y * w * 3, w, 3,
                                luma.data());
        rs.feed(luma.data());
    }
    if (!rs.complete()) return -6;
    return 0;
}

// Decode to the (nh, nw) u8 probe luma; fw/fh get the full dims.
// Nonzero return => caller falls back to the PIL path.  The w*h*3
// RGB vector can throw bad_alloc for a legal large WebP on a
// memory-constrained host; an exception must never cross the ctypes
// boundary (std::terminate would kill the scan process), so any
// throw degrades to the PIL route like every other failure.
int webp_luma_probe(const uint8_t* data, int64_t len, int nw, int nh,
                    uint8_t* out, int* fw, int* fh) {
    try {
        return webp_luma_probe_impl(data, len, nw, nh, out, fw, fh);
    } catch (...) {
        return -99;
    }
}

}  // extern "C"
