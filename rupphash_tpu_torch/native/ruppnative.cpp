// ruppnative — native host-side hot paths for rupphash_tpu.
//
// The reference implementation keeps its entire runtime in a compiled
// language; this library plays the same role for the Python orchestration
// layer here: the host-side operations that run per-file at scan rate are
// implemented in C++ and exposed over a C ABI consumed via ctypes
// (rupphash_tpu/native/__init__.py), with pure-Python fallbacks when the
// toolchain is unavailable.
//
// Contents:
//   hchacha20         cache value-encryption subkey derivation
//                     (RFC draft irtf-cfrg-xchacha section 2.2)
//   luma601           integer Rec.601 luma (pdqhash.rs:268-284 semantics)
//   box_resample_u8   area-average pre-downsample, float64 accumulate,
//                     round-half-away (matches ops/pdq_ref.py exactly)
//   union_find        path-halving union-find over an edge list
//                     (scanner.rs:1780-1807 semantics)
//   huffio            shared canonical-Huffman bit I/O for the LJ92
//                     and Nikon-34713 decoders (one implementation,
//                     jpeg-stuffing vs plain modes)
//
// Build: g++ -O3 -shared -fPIC (see build.py). No external dependencies.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------
// HChaCha20
// ---------------------------------------------------------------------
static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

#define QR(a, b, c, d)                          \
    a += b; d ^= a; d = rotl32(d, 16);          \
    c += d; b ^= c; b = rotl32(b, 12);          \
    a += b; d ^= a; d = rotl32(d, 8);           \
    c += d; b ^= c; b = rotl32(b, 7);

void hchacha20(const uint8_t key[32], const uint8_t nonce[16],
               uint8_t out[32]) {
    uint32_t x[16];
    x[0] = 0x61707865u; x[1] = 0x3320646Eu;
    x[2] = 0x79622D32u; x[3] = 0x6B206574u;
    for (int i = 0; i < 8; i++)
        std::memcpy(&x[4 + i], key + 4 * i, 4);
    for (int i = 0; i < 4; i++)
        std::memcpy(&x[12 + i], nonce + 4 * i, 4);
    for (int r = 0; r < 10; r++) {
        QR(x[0], x[4], x[8],  x[12]);
        QR(x[1], x[5], x[9],  x[13]);
        QR(x[2], x[6], x[10], x[14]);
        QR(x[3], x[7], x[11], x[15]);
        QR(x[0], x[5], x[10], x[15]);
        QR(x[1], x[6], x[11], x[12]);
        QR(x[2], x[7], x[8],  x[13]);
        QR(x[3], x[4], x[9],  x[14]);
    }
    std::memcpy(out +  0, &x[0],  16);
    std::memcpy(out + 16, &x[12], 16);
}

// ---------------------------------------------------------------------
// XChaCha20-Poly1305 AEAD (RFC 8439 + draft-irtf-cfrg-xchacha).
//
// The cache envelope (cache/crypto.py, mirroring db.rs:634-673)
// encrypts every stored value; a warm rescan decrypts 4 values per
// file, and the per-value Python overhead (ctypes HChaCha20 subkey +
// a fresh `cryptography` AEAD object per value) measured ~35% of the
// probe loop.  One native call per value replaces all of it.
// Construction matches cache/crypto.py exactly: subkey =
// HChaCha20(key, nonce[0:16]); IETF ChaCha20-Poly1305 with 12-byte
// nonce = 4 zero bytes || nonce[16:24]; AAD-authenticated tag.
// ---------------------------------------------------------------------
static inline uint32_t le32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // x86/LE hosts; matches the struct.unpack("<L") fallback
}

static void chacha20_block(const uint32_t key[8], uint32_t counter,
                           const uint32_t nonce[3], uint8_t out[64]) {
    uint32_t s[16], x[16];
    s[0] = 0x61707865u; s[1] = 0x3320646Eu;
    s[2] = 0x79622D32u; s[3] = 0x6B206574u;
    for (int i = 0; i < 8; i++) s[4 + i] = key[i];
    s[12] = counter;
    for (int i = 0; i < 3; i++) s[13 + i] = nonce[i];
    std::memcpy(x, s, sizeof(x));
    for (int r = 0; r < 10; r++) {
        QR(x[0], x[4], x[8],  x[12]);
        QR(x[1], x[5], x[9],  x[13]);
        QR(x[2], x[6], x[10], x[14]);
        QR(x[3], x[7], x[11], x[15]);
        QR(x[0], x[5], x[10], x[15]);
        QR(x[1], x[6], x[11], x[12]);
        QR(x[2], x[7], x[8],  x[13]);
        QR(x[3], x[4], x[9],  x[14]);
    }
    for (int i = 0; i < 16; i++) x[i] += s[i];
    std::memcpy(out, x, 64);
}

// poly1305-donna-32: 26-bit limbs, 64-bit products.
struct Poly1305 {
    uint32_t r[5], h[5], pad[4];
    uint8_t buf[16];
    int buf_len = 0;

    void init(const uint8_t key[32]) {
        r[0] = (le32(key + 0)) & 0x3ffffff;
        r[1] = (le32(key + 3) >> 2) & 0x3ffff03;
        r[2] = (le32(key + 6) >> 4) & 0x3ffc0ff;
        r[3] = (le32(key + 9) >> 6) & 0x3f03fff;
        r[4] = (le32(key + 12) >> 8) & 0x00fffff;
        for (int i = 0; i < 5; i++) h[i] = 0;
        for (int i = 0; i < 4; i++) pad[i] = le32(key + 16 + 4 * i);
    }

    void blocks(const uint8_t* m, size_t len, uint32_t hibit) {
        const uint32_t s1 = r[1] * 5, s2 = r[2] * 5, s3 = r[3] * 5,
                       s4 = r[4] * 5;
        uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4];
        while (len >= 16) {
            h0 += (le32(m + 0)) & 0x3ffffff;
            h1 += (le32(m + 3) >> 2) & 0x3ffffff;
            h2 += (le32(m + 6) >> 4) & 0x3ffffff;
            h3 += (le32(m + 9) >> 6) & 0x3ffffff;
            h4 += (le32(m + 12) >> 8) | hibit;
            uint64_t d0 = (uint64_t)h0 * r[0] + (uint64_t)h1 * s4
                        + (uint64_t)h2 * s3 + (uint64_t)h3 * s2
                        + (uint64_t)h4 * s1;
            uint64_t d1 = (uint64_t)h0 * r[1] + (uint64_t)h1 * r[0]
                        + (uint64_t)h2 * s4 + (uint64_t)h3 * s3
                        + (uint64_t)h4 * s2;
            uint64_t d2 = (uint64_t)h0 * r[2] + (uint64_t)h1 * r[1]
                        + (uint64_t)h2 * r[0] + (uint64_t)h3 * s4
                        + (uint64_t)h4 * s3;
            uint64_t d3 = (uint64_t)h0 * r[3] + (uint64_t)h1 * r[2]
                        + (uint64_t)h2 * r[1] + (uint64_t)h3 * r[0]
                        + (uint64_t)h4 * s4;
            uint64_t d4 = (uint64_t)h0 * r[4] + (uint64_t)h1 * r[3]
                        + (uint64_t)h2 * r[2] + (uint64_t)h3 * r[1]
                        + (uint64_t)h4 * r[0];
            uint64_t c;
            c = d0 >> 26; h0 = (uint32_t)d0 & 0x3ffffff; d1 += c;
            c = d1 >> 26; h1 = (uint32_t)d1 & 0x3ffffff; d2 += c;
            c = d2 >> 26; h2 = (uint32_t)d2 & 0x3ffffff; d3 += c;
            c = d3 >> 26; h3 = (uint32_t)d3 & 0x3ffffff; d4 += c;
            c = d4 >> 26; h4 = (uint32_t)d4 & 0x3ffffff;
            h0 += (uint32_t)c * 5;
            uint32_t cc = h0 >> 26; h0 &= 0x3ffffff; h1 += cc;
            m += 16;
            len -= 16;
        }
        h[0] = h0; h[1] = h1; h[2] = h2; h[3] = h3; h[4] = h4;
    }

    void update(const uint8_t* m, size_t len) {
        if (buf_len) {
            size_t take = 16 - buf_len;
            if (take > len) take = len;
            std::memcpy(buf + buf_len, m, take);
            buf_len += (int)take;
            m += take;
            len -= take;
            if (buf_len == 16) {
                blocks(buf, 16, 1u << 24);
                buf_len = 0;
            }
        }
        size_t full = len & ~(size_t)15;
        if (full) blocks(m, full, 1u << 24);
        m += full;
        len -= full;
        if (len) {
            std::memcpy(buf, m, len);
            buf_len = (int)len;
        }
    }

    void pad16() {
        // AEAD layout: zero-pad each section to a 16-byte boundary
        if (buf_len) {
            std::memset(buf + buf_len, 0, 16 - buf_len);
            blocks(buf, 16, 1u << 24);
            buf_len = 0;
        }
    }

    void finish(uint8_t mac[16]) {
        if (buf_len) {
            // final partial block: append 0x01 then zeros, no hibit
            buf[buf_len] = 1;
            std::memset(buf + buf_len + 1, 0, 16 - buf_len - 1);
            blocks(buf, 16, 0);
            buf_len = 0;
        }
        uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4];
        uint32_t c;
        c = h1 >> 26; h1 &= 0x3ffffff; h2 += c;
        c = h2 >> 26; h2 &= 0x3ffffff; h3 += c;
        c = h3 >> 26; h3 &= 0x3ffffff; h4 += c;
        c = h4 >> 26; h4 &= 0x3ffffff; h0 += c * 5;
        c = h0 >> 26; h0 &= 0x3ffffff; h1 += c;

        uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
        uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
        uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
        uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
        uint32_t g4 = h4 + c - (1u << 26);

        uint32_t mask = (g4 >> 31) - 1;  // all-ones when h >= p
        h0 = (g0 & mask) | (h0 & ~mask);
        h1 = (g1 & mask) | (h1 & ~mask);
        h2 = (g2 & mask) | (h2 & ~mask);
        h3 = (g3 & mask) | (h3 & ~mask);
        h4 = (g4 & mask) | (h4 & ~mask);

        h0 = (h0 | (h1 << 26));
        h1 = ((h1 >> 6) | (h2 << 20));
        h2 = ((h2 >> 12) | (h3 << 14));
        h3 = ((h3 >> 18) | (h4 << 8));

        uint64_t f;
        f = (uint64_t)h0 + pad[0];              h0 = (uint32_t)f;
        f = (uint64_t)h1 + pad[1] + (f >> 32);  h1 = (uint32_t)f;
        f = (uint64_t)h2 + pad[2] + (f >> 32);  h2 = (uint32_t)f;
        f = (uint64_t)h3 + pad[3] + (f >> 32);  h3 = (uint32_t)f;
        std::memcpy(mac + 0,  &h0, 4);
        std::memcpy(mac + 4,  &h1, 4);
        std::memcpy(mac + 8,  &h2, 4);
        std::memcpy(mac + 12, &h3, 4);
    }
};

static void xchacha_core(const uint8_t key[32], const uint8_t nonce[24],
                         const uint8_t* aad, int64_t aad_len,
                         const uint8_t* in, int64_t len, uint8_t* out,
                         const uint8_t* mac_over, uint8_t tag[16]) {
    // subkey + 12-byte nonce per the xchacha draft (cache/crypto.py)
    uint8_t subkey[32];
    hchacha20(key, nonce, subkey);
    uint32_t k[8], n12[3];
    for (int i = 0; i < 8; i++) k[i] = le32(subkey + 4 * i);
    n12[0] = 0;
    n12[1] = le32(nonce + 16);
    n12[2] = le32(nonce + 20);

    uint8_t block[64];
    // poly key = first 32 bytes of block 0 (RFC 8439 2.6)
    chacha20_block(k, 0, n12, block);
    Poly1305 poly;
    poly.init(block);

    // stream cipher from counter 1
    uint32_t counter = 1;
    for (int64_t off = 0; off < len; off += 64) {
        chacha20_block(k, counter++, n12, block);
        int64_t chunk = len - off < 64 ? len - off : 64;
        for (int64_t i = 0; i < chunk; i++)
            out[off + i] = in[off + i] ^ block[i];
    }

    // tag = Poly1305(aad || pad || ct || pad || le64 lens)
    if (aad_len) poly.update(aad, (size_t)aad_len);
    poly.pad16();
    if (len) poly.update(mac_over, (size_t)len);
    poly.pad16();
    uint8_t lens[16];
    uint64_t al = (uint64_t)aad_len, cl = (uint64_t)len;
    std::memcpy(lens, &al, 8);
    std::memcpy(lens + 8, &cl, 8);
    poly.update(lens, 16);
    poly.finish(tag);
}

// out = ciphertext || 16-byte tag (pt_len + 16 bytes)
void xchacha20poly1305_seal(const uint8_t key[32], const uint8_t nonce[24],
                            const uint8_t* aad, int64_t aad_len,
                            const uint8_t* pt, int64_t pt_len,
                            uint8_t* out) {
    xchacha_core(key, nonce, aad, aad_len, pt, pt_len, out, out,
                 out + pt_len);
}

// ct_len includes the trailing tag; returns 0 and writes ct_len-16
// plaintext bytes on success, -1 on tag mismatch (out is zeroed).
int xchacha20poly1305_open(const uint8_t key[32], const uint8_t nonce[24],
                           const uint8_t* aad, int64_t aad_len,
                           const uint8_t* ct, int64_t ct_len,
                           uint8_t* out) {
    if (ct_len < 16) return -1;
    int64_t len = ct_len - 16;
    uint8_t tag[16];
    xchacha_core(key, nonce, aad, aad_len, ct, len, out, ct, tag);
    uint8_t diff = 0;  // constant-time compare
    for (int i = 0; i < 16; i++) diff |= (uint8_t)(tag[i] ^ ct[len + i]);
    if (diff) {
        std::memset(out, 0, (size_t)len);
        return -1;
    }
    return 0;
}

// ---------------------------------------------------------------------
// Rec.601 integer luma: (299 r + 587 g + 114 b + 500) / 1000
// ---------------------------------------------------------------------
void luma601(const uint8_t* px, int64_t n_px, int channels, uint8_t* out) {
    if (channels == 1) {
        std::memcpy(out, px, (size_t)n_px);
        return;
    }
    for (int64_t i = 0; i < n_px; i++) {
        const uint8_t* p = px + i * channels;
        uint32_t l = (299u * p[0] + 587u * p[1] + 114u * p[2] + 500u) / 1000u;
        out[i] = (uint8_t)l;
    }
}

// ---------------------------------------------------------------------
// Area-average box resample, u8 -> u8 (float64 accumulate).
// Matches rupphash_tpu.ops.pdq_ref.box_resample_u8: rows pass then cols
// pass, per-output normalization, round half away from zero.
// ---------------------------------------------------------------------
static void axis_weights(int src, int dst, std::vector<int>& starts,
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
            w[k - k0] = std::min(hi, (double)(k + 1)) - std::max(lo, (double)k);
    }
}

void box_resample_u8(const uint8_t* src, int h, int w,
                     uint8_t* dst, int nh, int nw) {
    // Bit-exactness note: each output element's weighted sum runs over
    // k in the SAME ascending order as the Python reference (the loop
    // nests below only reorder the independent j/i dimensions for
    // sequential memory access), so results stay identical while the
    // full-size float64 staging copy — which dominated 4 MP timings —
    // is gone (the rows pass reads the u8 source directly; u8->double
    // conversion is exact).
    std::vector<double> acc;
    int ch = h, cw = w;
    if (nh != h) {
        std::vector<int> starts;
        std::vector<std::vector<double>> wts;
        axis_weights(h, nh, starts, wts);
        std::vector<double> tmp((size_t)nh * w);
        for (int i = 0; i < nh; i++) {
            const auto& wv = wts[i];
            double wsum = 0;
            for (double x : wv) wsum += x;
            double* out_row = &tmp[(size_t)i * w];
            for (int j = 0; j < w; j++) out_row[j] = 0.0;
            for (size_t k = 0; k < wv.size(); k++) {
                const double wk = wv[k];
                const uint8_t* in_row =
                    src + (size_t)(starts[i] + k) * w;
                for (int j = 0; j < w; j++)
                    out_row[j] += wk * (double)in_row[j];
            }
            const double inv = wsum;
            for (int j = 0; j < w; j++) out_row[j] /= inv;
        }
        acc.swap(tmp);
        ch = nh;
    } else {
        acc.resize((size_t)h * w);
        for (int64_t i = 0; i < (int64_t)h * w; i++) acc[i] = src[i];
    }
    if (nw != w) {
        std::vector<int> starts;
        std::vector<std::vector<double>> wts;
        axis_weights(w, nw, starts, wts);
        std::vector<double> wsums(nw);
        for (int j = 0; j < nw; j++) {
            double s = 0;
            for (double x : wts[j]) s += x;
            wsums[j] = s;
        }
        std::vector<double> tmp((size_t)ch * nw);
        for (int i = 0; i < ch; i++) {
            const double* in_row = &acc[(size_t)i * cw];
            double* out_row = &tmp[(size_t)i * nw];
            for (int j = 0; j < nw; j++) {
                const auto& wv = wts[j];
                const double* p = in_row + starts[j];
                double v = 0;
                for (size_t k = 0; k < wv.size(); k++)
                    v += p[k] * wv[k];
                out_row[j] = v / wsums[j];
            }
        }
        acc.swap(tmp);
        cw = nw;
    }
    for (int64_t i = 0; i < (int64_t)ch * cw; i++) {
        double r = std::floor(acc[i] + 0.5);
        dst[i] = (uint8_t)std::max(0.0, std::min(255.0, r));
    }
}

// ---------------------------------------------------------------------
// Union-find with path halving; writes each node's final root.
// ---------------------------------------------------------------------
void union_find(int64_t n, const int64_t* ei, const int64_t* ej,
                int64_t m, int64_t* parent) {
    for (int64_t i = 0; i < n; i++) parent[i] = i;
    auto find = [&](int64_t i) {
        while (parent[i] != i) {
            parent[i] = parent[parent[i]];
            i = parent[i];
        }
        return i;
    };
    for (int64_t e = 0; e < m; e++) {
        int64_t ri = find(ei[e]), rj = find(ej[e]);
        if (ri != rj) parent[ri] = rj;
    }
    for (int64_t i = 0; i < n; i++) parent[i] = find(i);
}

// ---------------------------------------------------------------------
// Lossless JPEG (ITU-T T.81 process 14, "LJ92") decoder — the
// compression DNG uses for raw CFA tiles (Compression=7).  The
// reference gets this from LibRaw (SURVEY.md §2.7); here it is a
// from-scratch implementation of the spec: SOF3 frame, DHT Huffman
// tables, SOS with predictor selection 1-7, point transform, restart
// markers, FF00 byte unstuffing.  Interleaved components are emitted
// row-major as (h, w*ncomp) uint16, which maps linearly onto the CFA
// mosaic row (python side reshapes).
// ---------------------------------------------------------------------
// Shared canonical-Huffman bit I/O for the two JPEG-family codecs
// below (LJ92 and Nikon 34713).  One implementation, two stuffing
// modes: jpeg_stuffing handles FF00 unstuffing + marker stops (T.81),
// plain mode feeds the raw bytes (Nikon's stream has no stuffing).
// Both zero-feed past end-of-stream; the raster geometry bounds every
// decode loop, so truncation cannot spin.
namespace huffio {

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t bits = 0;
    int nbits = 0;
    bool jpeg_stuffing;

    BitReader(const uint8_t* data, const uint8_t* e, bool jpeg)
        : p(data), end(e), jpeg_stuffing(jpeg) {}

    void refill() {
        while (nbits <= 24) {
            if (p >= end) { nbits += 8; continue; }
            uint8_t b = *p++;
            if (jpeg_stuffing && b == 0xFF) {
                if (p < end && *p == 0x00) {
                    p++;  // stuffed byte
                } else {
                    // marker (EOI / RSTn handled by caller via reset)
                    p--;
                    nbits += 8;  // feed zeros at the marker
                    continue;
                }
            }
            bits |= (uint32_t)b << (24 - nbits);
            nbits += 8;
        }
    }
    int get(int n) {
        if (n <= 0) return 0;
        if (nbits < n) refill();
        int v = (int)(bits >> (32 - n));
        bits <<= n;
        nbits -= n;
        return v;
    }
    bool align_to_marker() {  // skip padding + stuffing to RSTn
        bits = 0; nbits = 0;
        while (p + 1 < end) {
            if (*p != 0xFF) { p++; continue; }
            if (p[1] == 0xFF) { p++; continue; }     // T.81 B.1.1.2 fill
            if (p[1] >= 0xD0 && p[1] <= 0xD7) { p += 2; return true; }
            if (p[1] == 0x00) { p += 2; continue; }  // stuffed pad byte
            return false;  // some other marker: the restart is missing
        }
        return false;
    }
};

struct Huff {
    // canonical per-length first-code table
    int mincode[17], maxcode[17], valptr[17];
    uint8_t vals[256];
    bool ok = false;

    void build(const uint8_t counts[16], const uint8_t* values, int nv) {
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            code += counts[l - 1];
            maxcode[l] = code - 1;
            code <<= 1;
            k += counts[l - 1];
        }
        for (int i = 0; i < nv && i < 256; i++) vals[i] = values[i];
        ok = true;
    }
    int decode(BitReader& br) const {
        int code = 0;
        for (int l = 1; l <= 16; l++) {
            code = (code << 1) | br.get(1);
            if (maxcode[l] >= mincode[l] && code <= maxcode[l] &&
                code >= mincode[l])
                return vals[valptr[l] + code - mincode[l]];
        }
        return -1;
    }
};

}  // namespace huffio

namespace lj92 {

using huffio::BitReader;
using huffio::Huff;

static inline int extend(int v, int ssss) {
    // T.81 F.2.2.1 sign extension of a magnitude category
    if (ssss == 0) return 0;
    if (ssss == 16) return 32768;  // special: diff = 32768, no bits
    return (v < (1 << (ssss - 1))) ? v - (1 << ssss) + 1 : v;
}

}  // namespace lj92

// ---------------------------------------------------------------------
// Nikon NEF compressed CFA raster (TIFF Compression 34713).
//
// The reference decodes these through LibRaw (SURVEY.md §2.7,
// gui/image.rs:1886-1945); this is a from-scratch implementation of the
// published bitstream format (documented for two decades by dcraw /
// LibRaw / exiftool): a per-file Huffman table chosen from six fixed
// canonical trees, MSB-first bitstream of (category, magnitude-bits)
// diffs with an optional "shift" in the leaf value (lossy variants
// quantize diffs to odd multiples of 2^(shl-1)), two vertical
// predictors seeding columns 0/1 of each row pair, horizontal
// prediction with column parity thereafter, and a final lookup through
// the camera curve from MakerNote tag 0x0096 clamped to [0, 0x3fff].
// Tree tables are format constants (counts for code lengths 1..16,
// then leaf values; rows zero-padded — tree 0's 14th leaf is the pad).
// The caller (pipeline/rawcontainers.py) parses the 0x0096 block into
// (vpred, curve LUT, base tree index, split row) and hands them here.
// ---------------------------------------------------------------------
namespace nef {

static const uint8_t kTree[6][32] = {
    // 12-bit lossy
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12, 0, 0, 0},
    // 12-bit lossy, after the split row
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     0x39, 0x5a, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12, 0, 0},
    // 12-bit lossless
    {0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12, 0, 0, 0},
    // 14-bit lossy
    {0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14, 0},
    // 14-bit lossy, after the split row
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0,
     8, 0x5c, 0x4b, 0x3a, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14, 0},
    // 14-bit lossless
    {0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0,
     7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14, 0}};

using huffio::BitReader;
using huffio::Huff;

}  // namespace nef

// Decode a Nikon 34713 strip.  vpred_in = 4 u16 seeds ([row&1][col]),
// curve = 0x4000-entry LUT, tree = base tree index (0..5), split = row
// at which lossy streams switch to tree+1 (0 = never).  Returns 0 ok.
int nef_decode(const uint8_t* data, int64_t len, const uint16_t* vpred_in,
               const uint16_t* curve, int width, int height, int tree,
               int split, uint16_t* out) {
    using namespace nef;
    if (tree < 0 || tree > 5 || width <= 0 || height <= 0) return -1;
    if (split != 0 && tree != 0 && tree != 3) return -2;
    auto nv = [](const uint8_t* row) {
        int n = 0;
        for (int i = 0; i < 16; i++) n += row[i];
        return n;
    };
    Huff hu;
    hu.build(kTree[tree], kTree[tree] + 16, nv(kTree[tree]));
    BitReader br(data, data + len, false);
    uint16_t vpred[2][2] = {{vpred_in[0], vpred_in[1]},
                            {vpred_in[2], vpred_in[3]}};
    uint16_t hpred[2] = {0, 0};
    for (int row = 0; row < height; row++) {
        if (split != 0 && row == split)
            hu.build(kTree[tree + 1], kTree[tree + 1] + 16,
                     nv(kTree[tree + 1]));
        for (int col = 0; col < width; col++) {
            int leaf = hu.decode(br);
            if (leaf < 0) return -3;
            int lenb = leaf & 15, shl = leaf >> 4;
            int b = br.get(lenb - shl);
            int diff = (((b << 1) + 1) << shl) >> 1;
            if (lenb > 0 && (diff & (1 << (lenb - 1))) == 0)
                diff -= (1 << lenb) - (shl ? 0 : 1);
            uint16_t v;
            if (col < 2) {
                vpred[row & 1][col] =
                    (uint16_t)(vpred[row & 1][col] + diff);
                v = hpred[col] = vpred[row & 1][col];
            } else {
                hpred[col & 1] = (uint16_t)(hpred[col & 1] + diff);
                v = hpred[col & 1];
            }
            int16_t sv = (int16_t)v;
            int idx = sv < 0 ? 0 : (sv > 0x3fff ? 0x3fff : sv);
            out[(int64_t)row * width + col] = curve[idx];
        }
    }
    return 0;
}

// ---------------------------------------------------------------------
// Sony ARW2 compressed CFA raster (TIFF Compression 32767, 1 byte/px).
//
// Published block format (dcraw/LibRaw "sony_arw2"): each 16-byte block
// encodes 16 same-parity pixels of a row as an 11-bit max, 11-bit min,
// two 4-bit indices saying which of the 16 pixels are the max/min, and
// fourteen 7-bit deltas above min scaled by a shift derived from
// (max - min); blocks alternate even/odd column phases so 32 bytes
// cover 32 consecutive columns.  Decoded 11-bit values are mapped
// through the camera tone curve (SR2 tag 0x7010 knees, built by the
// caller) as curve[pix << 1] >> 2.  The reference reaches this via
// LibRaw (SURVEY.md §2.7); this is a from-scratch implementation.
// row_stride = bytes per row in the stream (== width for real files).
// ---------------------------------------------------------------------
int arw2_decode(const uint8_t* data, int64_t len, const uint16_t* curve,
                int width, int height, int row_stride, uint16_t* out) {
    if (width < 32 || height <= 0 || row_stride < width) return -1;
    if ((int64_t)row_stride * height > len) return -2;
    for (int row = 0; row < height; row++) {
        const uint8_t* rp = data + (int64_t)row * row_stride;
        const uint8_t* rend = data + len;
        int col = 0;
        for (const uint8_t* dp = rp; col < width - 30; dp += 16) {
            uint32_t val = (uint32_t)dp[0] | (uint32_t)dp[1] << 8 |
                           (uint32_t)dp[2] << 16 | (uint32_t)dp[3] << 24;
            int mx = (int)(val & 0x7ff);
            int mn = (int)((val >> 11) & 0x7ff);
            int imax = (int)((val >> 22) & 0x0f);
            int imin = (int)((val >> 26) & 0x0f);
            int sh;
            for (sh = 0; sh < 4 && (0x80 << sh) <= mx - mn; sh++) {}
            uint16_t pix[16];
            int bit = 30;
            for (int i = 0; i < 16; i++) {
                if (i == imax) {
                    pix[i] = (uint16_t)mx;
                } else if (i == imin) {
                    pix[i] = (uint16_t)mn;
                } else {
                    // 7-bit field may touch the byte after the block;
                    // that byte is only safe to read inside the buffer
                    int lo = dp[bit >> 3];
                    int hi = (dp + (bit >> 3) + 1 < rend)
                                 ? dp[(bit >> 3) + 1] : 0;
                    int word = lo | hi << 8;
                    int p = (((word >> (bit & 7)) & 0x7f) << sh) + mn;
                    pix[i] = (uint16_t)(p > 0x7ff ? 0x7ff : p);
                    bit += 7;
                }
            }
            for (int i = 0; i < 16; i++, col += 2)
                out[(int64_t)row * width + col] =
                    (uint16_t)(curve[pix[i] << 1] >> 2);
            col -= (col & 1) ? 1 : 31;
        }
        // trailing < 32-column partial block (sensor padding): zero
        for (; col < width; col++)
            out[(int64_t)row * width + col] = 0;
    }
    return 0;
}

// Panasonic RW2 12-bit predictive raster (the classic "Panasonic RAW"
// bitstream): 0x4000-byte blocks stored tail-first (the last 0x2008
// bytes of each block precede the first 0x1ff8 in consumption order),
// a down-counting 17-bit position register, and per-14-pixel groups of
// two parity-interleaved predictors with a 2-bit shift code every third
// pixel.  Published algorithm (dcraw/LibRaw panasonic_load_raw
// semantics), reimplemented from the format description.
namespace rw2 {
struct PanaBits {
    const uint8_t* data;
    int64_t len;
    int64_t pos;       // next block's file offset
    uint8_t buf[0x4000];
    int vbits = 0;
};
static int pana_bits(PanaBits& pb, int nbits) {
    if (!pb.vbits) {
        const int lf = 0x2008;      // RW2 load flags (block tail size)
        std::memset(pb.buf, 0, sizeof(pb.buf));
        int64_t remain = pb.len - pb.pos;
        if (remain < 0) remain = 0;
        int64_t n1 = 0x4000 - lf;   // bytes landing at buf[lf..)
        int64_t c1 = remain < n1 ? remain : n1;
        if (c1 > 0) std::memcpy(pb.buf + lf, pb.data + pb.pos, c1);
        int64_t c2 = remain - n1;
        if (c2 > 0) std::memcpy(pb.buf, pb.data + pb.pos + n1,
                                c2 < lf ? c2 : lf);
        pb.pos += 0x4000;
    }
    pb.vbits = (pb.vbits - nbits) & 0x1ffff;
    // 16-byte cells consumed tail-first: one 14-pixel group's 128 bits
    // tile exactly one cell (byte 15 down to 0 within each cell)
    int byte = (pb.vbits >> 3) ^ 0x3ff0;
    int hi = byte + 1 < 0x4000 ? pb.buf[byte + 1] : 0;
    return ((pb.buf[byte] | hi << 8) >> (pb.vbits & 7)) &
           ((1 << nbits) - 1);
}
}  // namespace rw2

int rw2_decode(const uint8_t* data, int64_t len, int width, int height,
               uint16_t* out) {
    using rw2::PanaBits;
    using rw2::pana_bits;
    if (width <= 0 || height <= 0) return -1;
    PanaBits pb;
    pb.data = data;
    pb.len = len;
    pb.pos = 0;
    pb.vbits = 0;
    int pred[2] = {0, 0}, nonz[2] = {0, 0}, sh = 0;
    for (int row = 0; row < height; row++) {
        for (int col = 0; col < width; col++) {
            int i = col % 14;
            if (i == 0) pred[0] = pred[1] = nonz[0] = nonz[1] = 0;
            if (i % 3 == 2) sh = 4 >> (3 - pana_bits(pb, 2));
            int p = i & 1;
            if (nonz[p]) {
                int j = pana_bits(pb, 8);
                if (j) {
                    pred[p] -= 0x80 << sh;
                    if (pred[p] < 0 || sh == 4)
                        pred[p] &= (1 << sh) - 1;
                    pred[p] += j << sh;
                }
            } else {
                nonz[p] = pana_bits(pb, 8);
                if (nonz[p] || i > 11)
                    pred[p] = nonz[p] << 4 | pana_bits(pb, 4);
            }
            int v = pred[col & 1];
            out[(int64_t)row * width + col] =
                (uint16_t)(v > 0xffff ? 0xffff : (v < 0 ? 0 : v));
        }
    }
    return 0;
}

// Panasonic RW2 v6 cell scheme (RawFormat 6): plain byte stream of
// 16-byte pages, each carrying 11 pixels as 14 packed entries — two
// full 14-bit pixels, then three groups of one 2-bit scale selector
// (code 3 means shift 4) and three 10-bit values.  The page
// bit-slicing layout follows the published description (rawspeed /
// LibRaw implement this format openly); the value reconstruction here
// is the family rule — odd/even base channels updated by the 10-bit
// entries as midpoint-relative deltas shifted by the group scale —
// validated by encoder roundtrip + a Python differential oracle
// (byte-exactness against real camera files is untestable in this
// image; RW2 v6 files that look implausible fall back to the embedded
// preview like every other raw tail).
int rw2_v6_decode(const uint8_t* data, int64_t len, int width,
                  int height, uint16_t* out) {
    if (width <= 0 || height <= 0) return -1;
    int64_t bpr = (width + 10) / 11;           // pages per row
    if (len != bpr * 16 * height) return -2;   // exact-size gate
    for (int row = 0; row < height; row++) {
        const uint8_t* rp = data + (int64_t)row * bpr * 16;
        for (int64_t blk = 0; blk < bpr; blk++) {
            const uint8_t* b = rp + blk * 16;
            unsigned e[14];
            e[0] = (b[3] << 6) | (b[2] >> 2);
            e[1] = (((b[2] & 3) << 12) | (b[1] << 4) | (b[0] >> 4))
                   & 0x3fff;
            e[2] = (b[0] >> 2) & 3;
            e[3] = ((b[0] & 3) << 8) | b[7];
            e[4] = ((b[6] << 2) | (b[5] >> 6)) & 0x3ff;
            e[5] = ((b[5] & 0x3f) << 4) | (b[4] >> 4);
            e[6] = (b[4] >> 2) & 3;
            e[7] = ((b[4] & 3) << 8) | b[11];
            e[8] = ((b[10] << 2) | (b[9] >> 6)) & 0x3ff;
            e[9] = ((b[9] << 4) | (b[8] >> 4)) & 0x3ff;
            e[10] = (b[8] >> 2) & 3;
            e[11] = ((b[8] & 3) << 8) | b[15];
            e[12] = ((b[14] << 2) | (b[13] >> 6)) & 0x3ff;
            e[13] = ((b[13] << 4) | (b[12] >> 4)) & 0x3ff;
            int64_t oddeven[2] = {(int64_t)e[0], (int64_t)e[1]};
            int64_t px[11];
            px[0] = oddeven[0];
            px[1] = oddeven[1];
            static const int vidx[3][3] = {{3, 4, 5}, {7, 8, 9},
                                           {11, 12, 13}};
            static const int sidx[3] = {2, 6, 10};
            for (int g = 0; g < 3; g++) {
                int sel = e[sidx[g]];
                int sh = sel == 3 ? 4 : sel;
                for (int k = 0; k < 3; k++) {
                    int pixi = 2 + g * 3 + k;
                    int64_t v = (int64_t)e[vidx[g][k]] - 0x200;
                    // multiply, not shift: v can be negative (UB)
                    int64_t r = oddeven[pixi & 1]
                                + v * ((int64_t)1 << sh);
                    if (r < 0) r = 0;
                    if (r > 0x3fff) r = 0x3fff;
                    px[pixi] = r;
                    oddeven[pixi & 1] = r;
                }
            }
            for (int k = 0; k < 11; k++) {
                int64_t col = blk * 11 + k;
                if (col < width)
                    out[(int64_t)row * width + col] = (uint16_t)px[k];
            }
        }
    }
    return 0;
}

// Panasonic RW2 v7 cell scheme (RawFormat 7): fixed-rate packing —
// each 16-byte block holds 9 pixels at 14 bits or 10 pixels at 12
// bits, little-endian bit order, rows starting on block boundaries.
// Published layout (LibRaw panasonicC7 semantics), reimplemented from
// the format description.
int rw2_v7_decode(const uint8_t* data, int64_t len, int width,
                  int height, int bps, uint16_t* out) {
    if (width <= 0 || height <= 0) return -1;
    if (bps != 12 && bps != 14) return -1;
    int ppb = bps == 14 ? 9 : 10;
    int64_t bpr = (width + ppb - 1) / ppb;
    if (len != bpr * 16 * height) return -2;
    for (int row = 0; row < height; row++) {
        const uint8_t* rp = data + (int64_t)row * bpr * 16;
        for (int64_t blk = 0; blk < bpr; blk++) {
            const uint8_t* b = rp + blk * 16;
            for (int k = 0; k < ppb; k++) {
                int64_t col = blk * ppb + k;
                if (col >= width) break;
                int bit0 = k * bps;
                unsigned v = 0;
                for (int j = 0; j < bps; j++) {
                    int bit = bit0 + j;
                    v |= (unsigned)((b[bit >> 3] >> (bit & 7)) & 1)
                         << j;
                }
                out[(int64_t)row * width + col] = (uint16_t)v;
            }
        }
    }
    return 0;
}

// Canon CR3 raw plane codec (the CRX lossless class): per-plane
// line-based MED (LOCO-I) prediction with adaptive Golomb-Rice residual
// coding — the published algorithm family of Canon's crx lossless mode
// (wavelet levels = 0).  The CR3 *container* parsing
// (pipeline/cr3.py) follows the documented ISOBMFF layout; this
// entropy layer is a self-consistent implementation of the family
// (validated by encoder roundtrip + a Python differential oracle, the
// NEF-34713 test pattern) — exact LibRaw bitstream compatibility is
// untestable here (no real CR3 fixtures in the image; those fall back
// to their embedded previews, the reference's hashing source).
namespace crx {
struct Bits {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;
    uint64_t acc = 0;
    int nacc = 0;
    int get(int n) {
        while (nacc < n) {
            uint8_t b = pos < len ? data[pos] : 0;
            pos++;
            acc = (acc << 8) | b;
            nacc += 8;
        }
        nacc -= n;
        return (int)((acc >> nacc) & ((1ull << n) - 1));
    }
    int zeros(int cap) {   // count zero bits up to cap (exclusive stop)
        int n = 0;
        while (n < cap && get(1) == 0) n++;
        return n;
    }
};
constexpr int ESCAPE_Q = 20;   // >= this many zeros -> explicit field
constexpr int RESET_N = 64;    // Golomb adaptation halving period
}  // namespace crx

int crx_decode_plane(const uint8_t* data, int64_t len, int width,
                     int height, int nbits, uint16_t* out) {
    using namespace crx;
    if (width <= 0 || height <= 0 || nbits < 2 || nbits > 16) return -1;
    Bits bits;
    bits.data = data;
    bits.len = len;
    int64_t A = 4;   // running absolute-residual sum (JPEG-LS style)
    int64_t N = 1;
    for (int row = 0; row < height; row++) {
        for (int col = 0; col < width; col++) {
            int a = col > 0 ? out[(int64_t)row * width + col - 1] : 0;
            int b = row > 0 ? out[(int64_t)(row - 1) * width + col] : 0;
            int c = (row > 0 && col > 0)
                        ? out[(int64_t)(row - 1) * width + col - 1] : 0;
            int pred;
            if (row == 0) pred = col > 0 ? a : 0;
            else if (col == 0) pred = b;
            else {
                int mx = a > b ? a : b, mn = a < b ? a : b;
                if (c >= mx) pred = mn;
                else if (c <= mn) pred = mx;
                else pred = a + b - c;
            }
            int k = 0;
            while ((N << k) < A && k < 15) k++;
            int q = bits.zeros(ESCAPE_Q + 1);
            int64_t u;
            if (q > ESCAPE_Q) return -2;       // ran off the stream
            if (q == ESCAPE_Q)
                u = bits.get(nbits + 2);
            else
                u = ((int64_t)q << k) | bits.get(k);
            int64_t err = (u & 1) ? -((u + 1) >> 1) : (u >> 1);
            int64_t v = pred + err;
            // a valid stream only encodes in-range samples; anything
            // outside [0, 2^nbits) marks a foreign/corrupt bitstream
            // (the advisor-r3 sanity gate: garbage must not silently
            // pass as pixels)
            if (v < 0 || (v >> nbits) != 0) return -3;
            out[(int64_t)row * width + col] = (uint16_t)v;
            A += u;
            N += 1;
            if (N == RESET_N) {
                A >>= 1;
                N >>= 1;
            }
        }
    }
    // exact-consumption gate: the encoder emits ceil(bits/8) bytes, so
    // a stream that leaves whole unread bytes (or ran past the end,
    // zero-filled) is not one of ours -> reject, caller falls back to
    // the embedded preview (the reference's hashing source)
    int64_t consumed_bytes = bits.pos - bits.nacc / 8;
    if (consumed_bytes != len) return -4;
    return 0;
}

// Canon CR3 wavelet class: the "CRAW" lossy family plus the lossless
// wavelet mode (CMP1 levels > 0).  Per CFA plane: LeGall 5/3 integer
// (reversible) wavelet pyramid, each subband an independent bitstream —
// one quantization-exponent byte (power-of-two step; 0 for lossless)
// followed by adaptive Golomb-Rice coded coefficients (zigzag signed,
// DPCM prediction on the LL band only).  Like the lossless MED class
// above, this is a self-consistent implementation of the published crx
// algorithm family (LibRaw implements it openly; the reference reaches
// it via FFI, gui/image.rs:1839-1962): validated by encoder roundtrip +
// a Python differential oracle; byte compatibility with real Canon
// bitstreams is untestable here, and the exact-consumption + range
// gates below make foreign streams fail closed to the preview path.
namespace crxw {
using crx::Bits;
using crx::ESCAPE_Q;
using crx::RESET_N;

// reversible 5/3 inverse lifting on a strided signal: in holds
// [s(0..ns-1) | d(0..nd-1)] packed low-then-high, out interleaved.
static void inv53(const int64_t* in, int64_t* out, int n, int stride) {
    int ns = (n + 1) / 2, nd = n / 2;
    if (n == 1) { out[0] = in[0]; return; }
    const int64_t* s = in;
    const int64_t* d = in + (int64_t)ns * stride;
    for (int j = 0; j < ns; j++) {
        int64_t dm1 = d[(int64_t)(j > 0 ? j - 1 : 0) * stride];
        int64_t dj = d[(int64_t)(j < nd ? j : nd - 1) * stride];
        out[(int64_t)2 * j * stride] =
            s[(int64_t)j * stride] - ((dm1 + dj + 2) >> 2);
    }
    for (int j = 0; j < nd; j++) {
        int64_t e0 = out[(int64_t)2 * j * stride];
        int64_t e1 = (2 * j + 2 <= n - 1)
                         ? out[(int64_t)(2 * j + 2) * stride] : e0;
        out[(int64_t)(2 * j + 1) * stride] =
            d[(int64_t)j * stride] + ((e0 + e1) >> 1);
    }
}

// decode one subband's quantized integer coefficients; returns 0 or a
// negative error.  q_exp is the leading byte; ll enables the DPCM
// prediction the LL band uses.
static int decode_band(const uint8_t* blob, int64_t blen, int bw, int bh,
                       int nbits, bool ll, int64_t* out) {
    if (blen < 1) return -20;
    int q_exp = blob[0];
    if (q_exp > ESCAPE_Q) return -21;
    Bits bits;
    bits.data = blob + 1;
    bits.len = blen - 1;
    int64_t A = 4, N = 1;
    for (int row = 0; row < bh; row++) {
        for (int col = 0; col < bw; col++) {
            int64_t pred = 0;
            if (ll) {
                if (col > 0) pred = out[(int64_t)row * bw + col - 1];
                else if (row > 0) pred = out[(int64_t)(row - 1) * bw];
            }
            int k = 0;
            while ((N << k) < A && k < 15) k++;
            int q = bits.zeros(ESCAPE_Q + 1);
            int64_t u;
            if (q > ESCAPE_Q) return -22;
            if (q == ESCAPE_Q)
                u = bits.get(nbits + 4);
            else
                u = ((int64_t)q << k) | bits.get(k);
            int64_t err = (u & 1) ? -((u + 1) >> 1) : (u >> 1);
            out[(int64_t)row * bw + col] = pred + err;
            A += u;
            N += 1;
            if (N == RESET_N) { A >>= 1; N >>= 1; }
        }
    }
    int64_t consumed_bytes = bits.pos - bits.nacc / 8;
    if (consumed_bytes != blen - 1) return -23;
    if (q_exp)
        // multiply, not shift: left-shifting negative coefficients is
        // UB pre-C++20 (same value, UBSan-clean)
        for (int64_t i = 0; i < (int64_t)bw * bh; i++)
            out[i] *= (int64_t)1 << q_exp;
    return 0;
}
}  // namespace crxw

// band_sizes: 3*levels+1 per-band byte sizes (stream order LL_L, then
// HL_l, LH_l, HH_l for l = levels..1), summing to len.  lossless != 0
// requires exact reconstruction in [0, 2^nbits); lossy clamps but
// rejects streams where more than 1/8 of samples need clamping (the
// plane-statistics sanity gate).
int crx_decode_plane_wavelet(const uint8_t* data, int64_t len,
                             const int64_t* band_sizes, int nbands,
                             int width, int height, int nbits,
                             int levels, int lossless, uint16_t* out) {
    using namespace crxw;
    if (width <= 0 || height <= 0 || nbits < 2 || nbits > 16) return -1;
    if (levels < 1 || levels > 8 || nbands != 3 * levels + 1) return -1;
    // per-level low-pass dims (lw[0] = full plane)
    int lw[9], lh[9];
    lw[0] = width; lh[0] = height;
    for (int l = 1; l <= levels; l++) {
        lw[l] = (lw[l - 1] + 1) / 2;
        lh[l] = (lh[l - 1] + 1) / 2;
        if (lw[l] < 1 || lh[l] < 1) return -1;
    }
    int64_t npix = (int64_t)width * height;
    std::vector<int64_t> canvas(npix, 0);
    std::vector<int64_t> scratch((size_t)(width > height ? width
                                                         : height) * 2);
    // decode bands into the canonical pyramid layout: level-l transform
    // of the canvas[0:lh[l-1], 0:lw[l-1]] block keeps s|d packed —
    // LL_l at (0,0), HL_l right of it, LH_l below, HH_l diagonal
    const uint8_t* p = data;
    int64_t remaining = len;
    int bi = 0;
    auto take = [&](int bw, int bh, bool ll, int r0, int c0) -> int {
        int64_t bsz = band_sizes[bi++];
        if (bsz < 0 || bsz > remaining) return -24;
        std::vector<int64_t> tmp((int64_t)bw * bh);
        int rc = decode_band(p, bsz, bw, bh, nbits, ll, tmp.data());
        if (rc) return rc;
        for (int r = 0; r < bh; r++)
            for (int c = 0; c < bw; c++)
                canvas[(int64_t)(r0 + r) * width + c0 + c] =
                    tmp[(int64_t)r * bw + c];
        p += bsz;
        remaining -= bsz;
        return 0;
    };
    int rc = take(lw[levels], lh[levels], true, 0, 0);
    if (rc) return rc;
    for (int l = levels; l >= 1; l--) {
        int cw = lw[l], ch = lh[l];             // low dims at this level
        int dw = lw[l - 1] - cw, dh = lh[l - 1] - ch;
        if (dw > 0 && (rc = take(dw, ch, false, 0, cw))) return rc;
        if (dh > 0 && (rc = take(cw, dh, false, ch, 0))) return rc;
        if (dw > 0 && dh > 0 && (rc = take(dw, dh, false, ch, cw)))
            return rc;
    }
    if (remaining != 0) return -25;   // plane blob exactly partitioned
    // inverse transform, deepest level first: columns then rows (the
    // forward applied rows then columns)
    for (int l = levels; l >= 1; l--) {
        int n_r = lh[l - 1], n_c = lw[l - 1];
        for (int c = 0; c < n_c; c++) {
            for (int r = 0; r < n_r; r++)
                scratch[r] = canvas[(int64_t)r * width + c];
            inv53(scratch.data(), scratch.data() + n_r, n_r, 1);
            for (int r = 0; r < n_r; r++)
                canvas[(int64_t)r * width + c] = scratch[n_r + r];
        }
        for (int r = 0; r < n_r; r++) {
            int64_t* rowp = &canvas[(int64_t)r * width];
            for (int c = 0; c < n_c; c++) scratch[c] = rowp[c];
            inv53(scratch.data(), scratch.data() + n_c, n_c, 1);
            for (int c = 0; c < n_c; c++) rowp[c] = scratch[n_c + c];
        }
    }
    int64_t maxv = ((int64_t)1 << nbits) - 1;
    int64_t clamped = 0;
    for (int64_t i = 0; i < npix; i++) {
        int64_t v = canvas[i];
        if (v < 0 || v > maxv) {
            if (lossless) return -26;
            clamped++;
            v = v < 0 ? 0 : maxv;
        }
        out[i] = (uint16_t)v;
    }
    if (!lossless && clamped * 8 > npix) return -27;
    return 0;
}

// Fujifilm compressed RAF (the X-Trans/Bayer lossless class): the
// published family structure (LibRaw implements it openly;
// the reference reaches it via FFI) — a 16-byte big-endian raster
// header ('I','S', version, raw_type, bits, height, rounded width,
// width, block size, blocks per row, total lines), a u32 per-stripe
// size table, then independently-coded vertical stripes.  Within a
// stripe, each sample is predicted from its nearest same-color
// neighbors on the X-Trans (or Bayer) lattice — left and up, found via
// the 6x6 pattern — and the residual is Golomb-Rice coded with
// per-color gradient-context adaptation (|a-b| quantized into 4
// classes, each with its own JPEG-LS-style (A, N) state).  Like the
// crx classes above this is a self-consistent implementation of the
// family validated by encoder roundtrip + Python differential oracle;
// exact-consumption and sample-range gates make foreign bitstreams
// fail closed to the embedded preview (the reference's hashing
// source, scanner.rs:1353-1380).
namespace fuji {
using crx::Bits;
using crx::ESCAPE_Q;
using crx::RESET_N;

struct Ctx { int64_t A = 4, N = 1; };

// gradient class of |a - b|
static inline int gclass(int64_t g) {
    if (g < 16) return 0;
    if (g < 64) return 1;
    if (g < 256) return 2;
    return 3;
}
}  // namespace fuji

int raf_decode(const uint8_t* data, int64_t len, int width, int height,
               const uint8_t* xtrans36, uint16_t* out) {
    using namespace fuji;
    if (width <= 0 || height <= 0 || len < 16) return -1;
    if (data[0] != 'I' || data[1] != 'S' || data[2] != 1) return -2;
    int bits = data[4];
    if (bits < 8 || bits > 16) return -2;
    int hh = (data[5] << 8) | data[6];
    int ww = (data[9] << 8) | data[10];
    int block_size = (data[11] << 8) | data[12];
    int blocks = data[13];
    if (hh != height || ww != width || block_size < 1) return -3;
    if (blocks != (width + block_size - 1) / block_size || blocks < 1)
        return -3;
    int64_t p = 16;
    if (p + 4LL * blocks > len) return -4;
    std::vector<int64_t> ssz(blocks);
    int64_t total = 0;
    for (int i = 0; i < blocks; i++) {
        ssz[i] = ((int64_t)data[p] << 24) | (data[p + 1] << 16) |
                 (data[p + 2] << 8) | data[p + 3];
        p += 4;
        total += ssz[i];
    }
    if (p + total != len) return -4;   // stripes exactly partition
    // nearest same-color left/up lattice offsets from the 6x6 pattern
    int dleft[6][6], dup[6][6];
    for (int rm = 0; rm < 6; rm++)
        for (int cm = 0; cm < 6; cm++) {
            int k = xtrans36[rm * 6 + cm] & 3;
            dleft[rm][cm] = dup[rm][cm] = 6;
            for (int d = 1; d <= 6; d++)
                if ((xtrans36[rm * 6 + ((cm - d) % 6 + 6) % 6] & 3)
                    == k) { dleft[rm][cm] = d; break; }
            for (int d = 1; d <= 6; d++)
                if ((xtrans36[(((rm - d) % 6 + 6) % 6) * 6 + cm] & 3)
                    == k) { dup[rm][cm] = d; break; }
        }
    int64_t maxv = ((int64_t)1 << bits) - 1;
    for (int s = 0; s < blocks; s++) {
        int c0 = s * block_size;
        int c1 = c0 + block_size < width ? c0 + block_size : width;
        Bits br;
        br.data = data + p;
        br.len = ssz[s];
        Ctx ctx[3][4];   // color x gradient class
        for (int r = 0; r < height; r++) {
            for (int c = c0; c < c1; c++) {
                int k = xtrans36[(r % 6) * 6 + c % 6] & 3;
                int dl = dleft[r % 6][c % 6], du = dup[r % 6][c % 6];
                bool has_a = c - dl >= c0;
                bool has_b = r - du >= 0;
                int64_t a = has_a ? out[(int64_t)r * width + c - dl] : 0;
                int64_t b = has_b
                                ? out[(int64_t)(r - du) * width + c] : 0;
                int64_t pred;
                if (has_a && has_b) pred = (a + b) >> 1;
                else if (has_a) pred = a;
                else if (has_b) pred = b;
                else pred = 0;
                Ctx& cx = ctx[k][has_a && has_b
                                     ? gclass(a > b ? a - b : b - a)
                                     : 0];
                int kk = 0;
                while ((cx.N << kk) < cx.A && kk < 15) kk++;
                int q = br.zeros(ESCAPE_Q + 1);
                int64_t u;
                if (q > ESCAPE_Q) return -5;
                if (q == ESCAPE_Q)
                    u = br.get(bits + 2);
                else
                    u = ((int64_t)q << kk) | br.get(kk);
                int64_t err = (u & 1) ? -((u + 1) >> 1) : (u >> 1);
                int64_t v = pred + err;
                if (v < 0 || v > maxv) return -6;
                out[(int64_t)r * width + c] = (uint16_t)v;
                cx.A += u;
                cx.N += 1;
                if (cx.N == RESET_N) { cx.A >>= 1; cx.N >>= 1; }
            }
        }
        int64_t consumed = br.pos - br.nacc / 8;
        if (consumed != ssz[s]) return -7;
        p += ssz[s];
    }
    return 0;
}

// Olympus ORF compressed raster ("Olympus compression"): MSB-first
// bitstream (after a 7-byte preamble), per-pixel 3-bit sign+low field,
// a unary-coded magnitude class with a 12-zero escape, per-parity
// carry state (magnitude, smoothed carry, small-run counter) driving
// an adaptive low-bit width, and a two-row/two-column gradient
// predictor.  Published algorithm (dcraw/LibRaw olympus_load_raw
// semantics), reimplemented from the format description.
namespace orf {
struct Bits {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;   // next byte
    uint64_t acc = 0;
    int nacc = 0;
    int get(int n) {
        while (nacc < n) {
            uint8_t b = pos < len ? data[pos] : 0;
            pos++;
            acc = (acc << 8) | b;
            nacc += 8;
        }
        nacc -= n;
        return (int)((acc >> nacc) & ((1u << n) - 1));
    }
};
}  // namespace orf

int orf_decode(const uint8_t* data, int64_t len, int width, int height,
               uint16_t* out) {
    using orf::Bits;
    if (width <= 0 || height <= 0 || len < 8) return -1;
    Bits bits;
    bits.data = data + 7;   // 7-byte preamble before the bitstream
    bits.len = len - 7;
    // int64 state: random/corrupt streams can push the escape path to
    // magnitudes that overflow int32 (the Python oracle uses bigints;
    // the differential fuzz requires identical arithmetic)
    int64_t acarry[2][3];
    for (int row = 0; row < height; row++) {
        std::memset(acarry, 0, sizeof(acarry));
        for (int col = 0; col < width; col++) {
            int64_t* carry = acarry[col & 1];
            int i = 2 * (carry[2] < 3);
            int nbits;
            for (nbits = 2 + i;
                 (uint16_t)carry[0] >> (nbits + i); nbits++) {}
            int field = bits.get(3);
            int low = field & 3;
            int sign = (field & 4) ? -1 : 0;
            // magnitude class: unary zero-run (the run length IS the
            // value, terminated by a 1); a full 12-zero run escapes to
            // an explicit (16-nbits)-bit field
            int high = 0;
            while (high < 12 && bits.get(1) == 0) high++;
            if (high == 12) high = bits.get(16 - nbits) >> 1;
            carry[0] = ((int64_t)high << nbits) | bits.get(nbits);
            int64_t diff = (carry[0] ^ sign) + carry[1];
            carry[1] = (diff * 3 + carry[1]) >> 5;
            carry[2] = carry[0] > 16 ? 0 : carry[2] + 1;
            int64_t pred;
            if (row < 2 && col < 2) pred = 0;
            else if (row < 2) pred = out[(int64_t)row * width + col - 2];
            else if (col < 2) pred = out[(int64_t)(row - 2) * width + col];
            else {
                int64_t w_ = out[(int64_t)row * width + col - 2];
                int64_t n_ = out[(int64_t)(row - 2) * width + col];
                int64_t nw = out[(int64_t)(row - 2) * width + col - 2];
                if ((w_ < nw && nw < n_) || (n_ < nw && nw < w_)) {
                    if (std::llabs(w_ - nw) > 32 ||
                        std::llabs(n_ - nw) > 32)
                        pred = w_ + n_ - nw;
                    else
                        pred = (w_ + n_) >> 1;
                } else {
                    pred = std::llabs(w_ - nw) > std::llabs(n_ - nw)
                               ? w_ : n_;
                }
            }
            int64_t v = pred + (diff * 4 | low);
            // stored as raw ushort (mod-65536 wrap, matching the
            // published decoder's ushort raster) — predictions read
            // the stored value
            out[(int64_t)row * width + col] = (uint16_t)v;
        }
    }
    return 0;
}

// Returns 0 on success.  out must hold out_cap uint16 samples; w/h/comps
// receive the SOF3 geometry (per-component width; row stride = w*comps).
int lj92_decode(const uint8_t* data, int64_t len, uint16_t* out,
                int64_t out_cap, int* out_w, int* out_h, int* out_comps) {
    using namespace lj92;
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return -1;
    p += 2;
    Huff tables[4];
    int precision = 0, W = 0, H = 0, NC = 0;
    int comp_table[4] = {0, 0, 0, 0};
    int predictor = 1, pt = 0;
    int restart_interval = 0;

    while (p + 4 <= end) {
        if (p[0] != 0xFF) return -2;
        int marker = p[1];
        p += 2;
        if (marker == 0xD9) return -3;  // EOI before SOS
        if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7))
            continue;  // segmentless (TEM / RSTn)
        int seglen = (p[0] << 8) | p[1];
        const uint8_t* seg = p + 2;
        const uint8_t* segend = p + seglen;
        // malformed lengths: shorter than the length field itself would
        // rewind the cursor (hang); beyond the buffer would over-read
        if (seglen < 2 || segend > end) return -4;
        if (marker == 0xC3) {  // SOF3
            if (segend - seg < 6) return -5;
            precision = seg[0];
            H = (seg[1] << 8) | seg[2];
            W = (seg[3] << 8) | seg[4];
            NC = seg[5];
            if (NC < 1 || NC > 4 || precision < 2 || precision > 16)
                return -5;
            p = segend;
        } else if (marker == 0xC4) {  // DHT (possibly several)
            const uint8_t* q = seg;
            while (q + 17 <= segend) {
                int tc_th = *q++;
                int th = tc_th & 0x0F;
                uint8_t counts[16];
                int nv = 0;
                for (int i = 0; i < 16; i++) { counts[i] = q[i]; nv += q[i]; }
                q += 16;
                if (q + nv > segend || th > 3 || nv > 256) return -6;
                tables[th].build(counts, q, nv);
                q += nv;
            }
            p = segend;
        } else if (marker == 0xDD) {  // DRI
            if (segend - seg < 2) return -4;
            restart_interval = (seg[0] << 8) | seg[1];
            p = segend;
        } else if (marker == 0xDA) {  // SOS
            if (segend - seg < 1) return -7;
            int ns = seg[0];
            if (ns != NC || NC == 0) return -7;
            if (segend - seg < 1 + 2 * ns + 3) return -7;
            for (int i = 0; i < ns; i++) {
                // 4-bit selector, but only tables[0..3] exist — an
                // unchecked 4..15 indexes garbage past the array
                comp_table[i] = (seg[1 + 2 * i + 1] >> 4) & 0x0F;
                if (comp_table[i] > 3) return -7;
            }
            predictor = seg[1 + 2 * ns];
            pt = seg[3 + 2 * ns] & 0x0F;
            if (pt >= precision) return -7;  // 1 << (P-1-Pt) must not
                                             // shift negatively
            p = segend;

            // ---- entropy-coded scan ----
            if ((int64_t)W * H * NC > out_cap) return -8;
            for (int i = 0; i < NC; i++)
                if (!tables[comp_table[i]].ok) return -9;
            BitReader br(p, end, true);
            int64_t stride = (int64_t)W * NC;
            int default_pred = 1 << (precision - 1 - pt);
            int64_t mcu = 0;
            bool just_restarted = false;
            for (int y = 0; y < H; y++) {
                for (int x = 0; x < W; x++) {
                    for (int c = 0; c < NC; c++) {
                        const Huff& hu = tables[comp_table[c]];
                        int ssss = hu.decode(br);
                        if (ssss < 0 || ssss > 16) return -10;
                        int diff = (ssss == 16) ? 32768
                                 : extend(br.get(ssss), ssss);
                        int pred;
                        if ((y == 0 && x == 0) || just_restarted)
                            pred = default_pred;  // T.81 H.2.1
                        else if (y == 0)
                            pred = out[(int64_t)x * NC - NC + c];
                        else if (x == 0)
                            pred = out[(int64_t)(y - 1) * stride + c];
                        else {
                            int a = out[(int64_t)y * stride
                                        + (int64_t)(x - 1) * NC + c];
                            int b = out[(int64_t)(y - 1) * stride
                                        + (int64_t)x * NC + c];
                            int cc = out[(int64_t)(y - 1) * stride
                                         + (int64_t)(x - 1) * NC + c];
                            switch (predictor) {
                                case 1: pred = a; break;
                                case 2: pred = b; break;
                                case 3: pred = cc; break;
                                case 4: pred = a + b - cc; break;
                                case 5: pred = a + ((b - cc) >> 1); break;
                                case 6: pred = b + ((a - cc) >> 1); break;
                                case 7: pred = (a + b) >> 1; break;
                                default: return -11;
                            }
                        }
                        int v = (pred + diff) & 0xFFFF;
                        out[(int64_t)y * stride + (int64_t)x * NC + c] =
                            (uint16_t)v;
                    }
                    just_restarted = false;
                    mcu++;
                    if (restart_interval && mcu % restart_interval == 0 &&
                        !(y == H - 1 && x == W - 1)) {
                        if (!br.align_to_marker())
                            return -14;  // expected RSTn is missing:
                                         // failing loudly beats
                                         // silently decoding zeros
                        just_restarted = true;
                    }
                }
            }
            *out_w = W; *out_h = H; *out_comps = NC;
            return 0;
        } else {
            p = segend;  // skip APPn/COM/etc.
        }
    }
    return -12;
}

}  // extern "C"
