// Fused PNG -> luma(+box-resample) probe decoder.
//
// Same architectural slot as ruppjpeg.cpp: the scan probe needs only
// (full dims, <=512px luma), so IDAT is inflated once with libdeflate
// (~2.6x zlib on this host), rows are unfiltered, reduced to Rec.601
// luma and streamed into the shared resample sink (rupp_stream.h) —
// the full RGB image and the PIL->numpy copy never exist.  ~4x host
// throughput for 4 MP PNGs.
//
// Bit-exactness: PNG is lossless, so any correct decode yields the
// same samples; the luma/resample stages reuse the exact golden math
// via rupp_stream.h.  Pillow-behavior mirroring for the accept/reject
// boundary (verified empirically, tests/test_pngfast.py):
//   * critical-chunk CRCs (IHDR, PLTE) are verified — Pillow checks
//     them at open and rejects the file;
//   * IDAT CRCs are NOT verified — Pillow's load path ignores them;
//   * ancillary-chunk CRCs are ignored — Pillow warns and continues;
//   * truncated/garbled zlib fails closed (Pillow raises too).
// Accepted class: 8-bit, non-interlaced, color types 0/2/3/4/6
// (palette via a 256-entry luma LUT = Pillow's P->RGB->luma exactly;
// gray+alpha: luma601(L,L,L) == L exactly).  Everything else returns
// nonzero and takes the PIL path.
//
// Reference parity: the reference full-decodes PNG on the host via
// the image crate before hashing (scanner.rs:716-735 generic path);
// same slot, copies fused away.
//
// Build (native/pngfast.py): g++ -O3 -march=native -ffp-contract=off
//   -shared -fPIC -std=c++17 ruppng.cpp -o ruppng.so -ldeflate

#include <cstdint>
#include <cstring>
#include <vector>

#include <libdeflate.h>

#include "rupp_stream.h"

namespace {

inline uint32_t be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// CRC-32 (ISO 3309), table-free bitwise is too slow; small table.
uint32_t crc32_png(const uint8_t* buf, size_t len) {
    static uint32_t table[256];
    static bool init = false;
    if (!init) {
        for (uint32_t n = 0; n < 256; n++) {
            uint32_t c = n;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            table[n] = c;
        }
        init = true;
    }
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Per-bpp specialized unfilter (the left-neighbor dependency chains
// are serial, but constant BPP removes the bounds checks and lets the
// filter-2 loop vectorize).  Returns false on an invalid filter byte.
template <int BPP>
bool unfilter_row(uint8_t* px, const uint8_t* prev, size_t n, int f) {
    switch (f) {
        case 0:
            return true;
        case 1:
            for (size_t i = BPP; i < n; i++) px[i] += px[i - BPP];
            return true;
        case 2:
            if (prev)
                for (size_t i = 0; i < n; i++) px[i] += prev[i];
            return true;
        case 3:
            if (!prev) {
                for (size_t i = BPP; i < n; i++)
                    px[i] += px[i - BPP] >> 1;
            } else {
                for (size_t i = 0; i < (size_t)BPP; i++)
                    px[i] += prev[i] >> 1;
                for (size_t i = BPP; i < n; i++)
                    px[i] += (uint8_t)((px[i - BPP] + prev[i]) >> 1);
            }
            return true;
        case 4:
            if (!prev) {  // Paeth degenerates to Sub on the first row
                for (size_t i = BPP; i < n; i++) px[i] += px[i - BPP];
            } else {
                for (size_t i = 0; i < (size_t)BPP; i++)
                    px[i] += prev[i];
                for (size_t i = BPP; i < n; i++)
                    px[i] += (uint8_t)paeth(px[i - BPP], prev[i],
                                            prev[i - BPP]);
            }
            return true;
        default:
            return false;
    }
}

}  // namespace

extern "C" {

// Parse a PNG header cheaply: returns 0 and fills w/h/color_type for
// the supported class (8-bit, non-interlaced, color 0/2/3/4/6),
// nonzero otherwise.  The Python wrapper uses this for target-dim
// computation and the MAX_PIXELS gate before the full decode.
int png_dims(const uint8_t* data, int64_t len, int* w, int* h,
             int* color_type) {
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G',
                                   0x0D, 0x0A, 0x1A, 0x0A};
    if (len < 8 + 25 || std::memcmp(data, sig, 8) != 0) return -1;
    if (be32(data + 8) != 13 ||
        std::memcmp(data + 12, "IHDR", 4) != 0)
        return -1;
    const uint8_t* ih = data + 16;
    uint32_t W = be32(ih), H = be32(ih + 4);
    int depth = ih[8], ct = ih[9], comp = ih[10], filt = ih[11],
        inter = ih[12];
    if (!W || !H || W > 0x7FFFFFFF || H > 0x7FFFFFFF) return -2;
    if (depth != 8 || comp != 0 || filt != 0 || inter != 0) return -3;
    if (ct != 0 && ct != 2 && ct != 3 && ct != 4 && ct != 6) return -3;
    *w = (int)W;
    *h = (int)H;
    *color_type = ct;
    return 0;
}

static int png_luma_probe_impl(const uint8_t* data, int64_t len,
                               int nw, int nh, uint8_t* out, int* fw,
                               int* fh) {
    int w, h, ct;
    int rc = png_dims(data, len, &w, &h, &ct);
    if (rc != 0) return rc;
    *fw = w;
    *fh = h;
    if (nw <= 0 || nh <= 0 || nw > w || nh > h) return -4;
    // Pillow verifies critical-chunk CRCs at open: IHDR here, PLTE in
    // the walk below.
    if (crc32_png(data + 12, 17) != be32(data + 29)) return -5;

    const int bpp = (ct == 0) ? 1 : (ct == 2) ? 3
                    : (ct == 3) ? 1 : (ct == 4) ? 2 : 4;
    uint8_t pal_luma[256];
    bool have_plte = false;

    // chunk walk: collect IDAT spans, verify PLTE
    std::vector<std::pair<const uint8_t*, size_t>> idat;
    size_t total_idat = 0;
    int64_t p = 8 + 25;
    while (p + 12 <= len) {
        uint32_t clen = be32(data + p);
        if ((int64_t)clen > len - p - 12) return -6;
        const uint8_t* typ = data + p + 4;
        const uint8_t* payload = data + p + 8;
        if (std::memcmp(typ, "IDAT", 4) == 0) {
            idat.emplace_back(payload, clen);  // CRC ignored (Pillow)
            total_idat += clen;
        } else if (std::memcmp(typ, "PLTE", 4) == 0) {
            if (clen > 768 || clen % 3 != 0) return -7;
            if (crc32_png(data + p + 4, clen + 4) !=
                be32(payload + clen))
                return -5;
            for (uint32_t i = 0; i * 3 < clen; i++)
                pal_luma[i] = ruppstream::luma601_px(payload + i * 3);
            // Pillow's P->RGB maps out-of-palette indices to entry 0
            // of a zero-filled palette; zero-fill the tail the same
            for (uint32_t i = clen / 3; i < 256; i++) {
                const uint8_t z[3] = {0, 0, 0};
                pal_luma[i] = ruppstream::luma601_px(z);
            }
            have_plte = true;
        } else if (std::memcmp(typ, "acTL", 4) == 0) {
            return -13;  // APNG: PIL's default-frame semantics own it
        } else if (std::memcmp(typ, "IEND", 4) == 0) {
            break;
        }
        // ancillary chunks: skipped, CRCs ignored (Pillow warns only)
        p += 12 + (int64_t)clen;
    }
    if (idat.empty()) return -8;
    if (ct == 3 && !have_plte) return -7;

    // inflate the concatenated IDAT stream in one shot
    const size_t stride = 1 + (size_t)w * bpp;
    const size_t rawlen = stride * (size_t)h;
    std::vector<uint8_t> z;
    const uint8_t* zp;
    size_t zlen;
    if (idat.size() == 1) {
        zp = idat[0].first;
        zlen = idat[0].second;
    } else {
        z.reserve(total_idat);
        for (auto& s : idat) z.insert(z.end(), s.first, s.first + s.second);
        zp = z.data();
        zlen = z.size();
    }
    std::vector<uint8_t> raw(rawlen);
    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return -9;
    size_t actual_out = 0;
    libdeflate_result r = libdeflate_zlib_decompress_ex(
        d, zp, zlen, raw.data(), rawlen, nullptr, &actual_out);
    libdeflate_free_decompressor(d);
    if (r != LIBDEFLATE_SUCCESS || actual_out != rawlen) return -10;

    // unfilter + luma + stream-resample, row by row (prev row needed
    // for filters 2/3/4, so unfilter in place over the raw buffer)
    ruppstream::StreamResampler rs;
    rs.init(w, h, nw, nh, out);
    std::vector<uint8_t> luma(w);
    const uint8_t* prev = nullptr;
    for (int y = 0; y < h; y++) {
        uint8_t* row = raw.data() + (size_t)y * stride;
        const int f = row[0];
        uint8_t* px = row + 1;
        const size_t n = (size_t)w * bpp;
        bool ok;
        switch (bpp) {
            case 1: ok = unfilter_row<1>(px, prev, n, f); break;
            case 2: ok = unfilter_row<2>(px, prev, n, f); break;
            case 3: ok = unfilter_row<3>(px, prev, n, f); break;
            default: ok = unfilter_row<4>(px, prev, n, f); break;
        }
        if (!ok) return -11;
        switch (ct) {
            case 0:  // gray
                rs.feed(px);
                break;
            case 2:  // RGB
                ruppstream::luma601_row(px, w, 3, luma.data());
                rs.feed(luma.data());
                break;
            case 3:  // palette: luma LUT == Pillow P->RGB->luma601
                for (int j = 0; j < w; j++) luma[j] = pal_luma[px[j]];
                rs.feed(luma.data());
                break;
            case 4:  // gray+alpha: luma601(L,L,L) == L exactly
                for (int j = 0; j < w; j++) luma[j] = px[(size_t)j * 2];
                rs.feed(luma.data());
                break;
            case 6:  // RGBA (luma reads RGB)
                ruppstream::luma601_row(px, w, 4, luma.data());
                rs.feed(luma.data());
                break;
        }
        prev = px;
    }
    if (!rs.complete()) return -12;
    return 0;
}

// Decode to the (nh, nw) u8 probe luma; fw/fh get the full dims.
// Nonzero return => caller falls back to the PIL path.  A legal
// ~100 MP PNG can make the inflate/raster vectors throw bad_alloc on
// a memory-constrained host; an exception must never cross the
// ctypes boundary (std::terminate would kill the scan process), so
// any throw degrades to the PIL route like every other failure.
int png_luma_probe(const uint8_t* data, int64_t len, int nw, int nh,
                   uint8_t* out, int* fw, int* fh) {
    try {
        return png_luma_probe_impl(data, len, nw, nh, out, fw, fh);
    } catch (...) {
        return -99;
    }
}

}  // extern "C"
