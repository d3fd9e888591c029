// Fused JPEG -> luma(+box-resample) probe decoder.
//
// The scan's hashing probe needs only (full dims, <=512px luma); the
// PIL route materializes the full RGB image, copies it into numpy
// (tobytes: as expensive as the decode itself at 4 MP on this host),
// then runs two more full-resolution passes (luma601, box_resample).
// This decoder streams libjpeg scanlines straight into the shared
// luma/area-resample sink (rupp_stream.h), so the full-resolution RGB
// never exists in memory and each decoded row is consumed cache-hot.
//
// Bit-exactness contract (tests/test_jpegfast.py): output is
// bit-identical to decode_bytes() -> luma601 -> box_resample_u8 for
// every stream it accepts.  Three layers enforce that:
//   1. pixel source: libjpeg defaults (JDCT_ISLOW + fancy upsampling)
//      match Pillow's JpegDecode.c settings; mismatched library
//      behavior is caught by the runtime self-probe in jpegfast.py.
//   2. luma: same integer math as ruppnative.cpp:luma601.
//   3. resample: rupp_stream.h StreamResampler (same float64 math and
//      addition order as ruppnative.cpp:box_resample_u8).
// Anything uncertain fails closed: non-8-bit precision, colorspaces
// other than grayscale/YCbCr/RGB, or ANY libjpeg warning (Pillow's
// tolerance for dirty streams differs by version, so dirty streams
// take the PIL path and inherit its exact behavior).
//
// Reference parity: the reference decodes JPEG on the host too
// (zune-jpeg full decode, scanner.rs:461-520) before hashing; this is
// the same architectural slot with the copies fused away.
//
// Build (native/jpegfast.py): g++ -O3 -march=native -ffp-contract=off
//   -shared -fPIC -std=c++17 ruppjpeg.cpp -o ruppjpeg.so -ljpeg
// (system libjpeg-turbo; absent => jpegfast disabled)

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#include "rupp_stream.h"

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
    ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// Silence stderr but keep the default handler's warning accounting:
// num_warnings is the fail-closed truncation/corruption signal.
void on_message(j_common_ptr cinfo, int msg_level) {
    if (msg_level < 0) cinfo->err->num_warnings++;
}

}  // namespace

extern "C" {

// Decode a JPEG stream and emit the hashing-probe luma directly:
// out is (nh, nw) u8 where (nw, nh) are the caller-computed target
// dims (pdq_ref.calculate_target_dimensions, or the full dims when no
// downsample applies).  fw/fh receive the decoded full dims (caller
// cross-checks them against its own header parse).  Returns 0 on
// success; any nonzero => caller falls back to the PIL path.
int jpeg_luma_probe(const uint8_t* data, int64_t len, int nw, int nh,
                    uint8_t* out, int* fw, int* fh) {
    if (len < 4 || nw <= 0 || nh <= 0) return -1;
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    // The resampler/row buffers are heap-held behind a *volatile*
    // pointer declared before setjmp: on_error longjmps out of
    // jpeg_read_scanlines, which would skip the destructors of any
    // automatic C++ objects scoped below (leaking the ~9 MB f64
    // accumulator per corrupt JPEG in a long-lived scan worker) — the
    // volatile pointer survives the jump by the setjmp rules, so both
    // exit paths delete it.
    struct ProbeCtx {
        ruppstream::StreamResampler rs;
        std::vector<uint8_t> row, luma;
    };
    ProbeCtx* volatile ctx = nullptr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = on_error;
    jerr.pub.emit_message = on_message;
    if (setjmp(jerr.jb)) {
        delete ctx;
        jpeg_destroy_decompress(&cinfo);
        return -4;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    // Fail closed on anything Pillow would decode through a different
    // pixel path: 12-bit precision, CMYK/YCCK (Pillow keeps CMYK mode
    // then converts), or exotic component counts.
    if (cinfo.data_precision != 8 ||
        !(cinfo.jpeg_color_space == JCS_GRAYSCALE ||
          cinfo.jpeg_color_space == JCS_YCbCr ||
          cinfo.jpeg_color_space == JCS_RGB)) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    const bool gray = (cinfo.jpeg_color_space == JCS_GRAYSCALE);
    cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
    // defaults match Pillow: dct_method JDCT_ISLOW, fancy upsampling
    jpeg_start_decompress(&cinfo);
    const int w = (int)cinfo.output_width;
    const int h = (int)cinfo.output_height;
    const int ch = cinfo.output_components;
    *fw = w;
    *fh = h;
    if (w <= 0 || h <= 0 || nw > w || nh > h ||
        (gray ? ch != 1 : ch != 3)) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }

    // Allocation can throw bad_alloc while cinfo is live; an exception
    // must never cross the ctypes boundary (std::terminate would kill
    // the scan process), so catch, destroy the codec, and fall back to
    // the PIL route.
    try {
        ctx = new ProbeCtx;
        ctx->rs.init(w, h, nw, nh, out);
        ctx->row.resize((size_t)w * ch);
        if (!gray) ctx->luma.resize(w);
    } catch (...) {
        delete ctx;
        jpeg_destroy_decompress(&cinfo);
        return -8;
    }
    JSAMPROW rp = ctx->row.data();
    while (cinfo.output_scanline < cinfo.output_height) {
        if (jpeg_read_scanlines(&cinfo, &rp, 1) != 1) {
            delete ctx;
            jpeg_destroy_decompress(&cinfo);
            return -6;
        }
        if (gray) {
            ctx->rs.feed(ctx->row.data());
        } else {
            ruppstream::luma601_row(ctx->row.data(), w, 3,
                                    ctx->luma.data());
            ctx->rs.feed(ctx->luma.data());
        }
    }
    jpeg_finish_decompress(&cinfo);
    // Pillow's per-version tolerance for dirty streams differs; any
    // warning (truncation, extraneous bytes, bad markers) fails closed
    // so the PIL path decides.
    const long warnings = cinfo.err->num_warnings;
    jpeg_destroy_decompress(&cinfo);
    const bool complete = ctx->rs.complete();
    delete ctx;
    if (warnings != 0) return -5;
    if (!complete) return -7;
    return 0;
}

}  // extern "C"
