// Native wire-codec decoders: one sequential pass a pair, threaded over
// pairs.
//
// The host-side inverses of denseflow_tpu_torch/wire.py's pack_chunk (v2),
// pack_chunk_v3 and pack_chunk_v4; wire.py has the buffer layouts. The port
// of the JAX package's native/wire.cpp, built on its own with g++ and
// -lpthread (no libjpeg or libpng), with size_t for every size, offset and
// count that can pass 2^31 (a 128-pair 1080x1920 v4 chunk is ~2.19e9
// bytes), and with the buffer's length passed in: a decode that would read
// past it returns 1 and writes nothing.

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// 2-bit code -> delta byte: {0: +0, 1: +1, 2: -1 (mod 256), 3: escape(+0)}
const uint8_t kDelta[4] = {0, 1, 255, 0};

constexpr uint32_t kPadIdx = 0xFFFFFF;

constexpr int kShort = 1;  // the buffer ends before the data it declares

template <typename Fn>
void parallel_pairs(int n, int n_threads, Fn fn) {
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            fn(i);
        }
    };
    std::vector<std::thread> pool;
    int k = std::min(n_threads, n);
    pool.reserve(k);
    for (int t = 0; t < k; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
}

inline uint32_t idx24(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
}

}  // namespace

extern "C" {

// v2. Outputs: flags (m bytes, 0/1), q (m*c*h*w bytes). Pairs whose flag
// is 0 are left unwritten in q (the caller takes the raw payload).
// Returns 0, or kShort when buf_len is below the v2 buffer size.
int df_wire_unpack(const uint8_t* buf, size_t buf_len, int m, int c, int h,
                   int w, int exc_cap, uint8_t* flags_out, uint8_t* q_out,
                   int n_threads) {
    const size_t rows = (size_t)c * h;
    const size_t n = w > 1 ? (size_t)(w - 1) : 0;
    const size_t cw = (n + 3) / 4;
    const size_t off_raw0 = (size_t)m;
    const size_t off_codes = off_raw0 + (size_t)m * rows;
    const size_t off_lo = off_codes + (size_t)m * rows * cw;
    const size_t off_mid = off_lo + (size_t)m * exc_cap;
    const size_t off_hi = off_mid + (size_t)m * exc_cap;
    const size_t off_val = off_hi + (size_t)m * exc_cap;
    if (buf_len < off_val + (size_t)m * exc_cap) return kShort;

    memcpy(flags_out, buf, m);
    parallel_pairs(m, n_threads, [&](int p) {
        if (!buf[p]) return;  // exception overflow: raw fallback
        const uint8_t* raw0 = buf + off_raw0 + (size_t)p * rows;
        const uint8_t* codes = buf + off_codes + (size_t)p * rows * cw;
        const uint8_t* lo = buf + off_lo + (size_t)p * exc_cap;
        const uint8_t* mid = buf + off_mid + (size_t)p * exc_cap;
        const uint8_t* hi = buf + off_hi + (size_t)p * exc_cap;
        const uint8_t* val = buf + off_val + (size_t)p * exc_cap;
        uint8_t* out = q_out + (size_t)p * rows * w;
        if (n == 0) {
            for (size_t r = 0; r < rows; ++r) out[r] = raw0[r];
            return;
        }
        // the pack writes each pair's escapes in ascending flat order, so
        // one cursor merges them into the stream
        int e = 0;
        auto exc_at = [&](int i) -> uint32_t {
            return (uint32_t)lo[i] | ((uint32_t)mid[i] << 8) | ((uint32_t)hi[i] << 16);
        };
        uint32_t next_exc = exc_cap > 0 ? exc_at(0) : kPadIdx;
        for (size_t r = 0; r < rows; ++r) {
            uint8_t acc = raw0[r];
            uint8_t* orow = out + r * w;
            const uint8_t* crow = codes + r * cw;
            orow[0] = acc;
            const uint32_t flat_base = (uint32_t)(r * n);
            for (size_t i = 0; i < n; ++i) {
                acc = (uint8_t)(acc + kDelta[(crow[i >> 2] >> (2 * (i & 3))) & 3]);
                if (flat_base + (uint32_t)i == next_exc) {
                    acc = (uint8_t)(acc + val[e]);
                    ++e;
                    next_exc = e < exc_cap ? exc_at(e) : kPadIdx;
                }
                orow[i + 1] = acc;
            }
        }
    });
    return 0;
}

// v3 (sparse-group codes + variable exception section). Sections: flags m
// | n_exc lo m | n_exc hi m | seeds m*rows | bitmap m*bw | codes (1 byte
// per occupied group, pair-major) | exc (4 bytes per escape, pair-major).
// Per-pair offsets come from bitmap popcounts and the n_exc counts: a
// serial prefix pass, then a parallel sweep over pairs. Returns 0, or
// kShort when buf_len is below the used length the buffer declares.
int df_wire_unpack_v3(const uint8_t* buf, size_t buf_len, int m, int c,
                      int h, int w, int exc_cap, uint8_t* flags_out,
                      uint8_t* q_out, int n_threads) {
    (void)exc_cap;  // overflowed pairs carry flag 0 and no entries
    const size_t rows = (size_t)c * h;
    const size_t n = w > 1 ? (size_t)(w - 1) : 0;
    const size_t gw = (n + 3) / 4;
    const size_t ng = rows * gw;
    const size_t bw = (ng + 7) / 8;
    const size_t off_exc_lo = (size_t)m;
    const size_t off_exc_hi = off_exc_lo + (size_t)m;
    const size_t off_seeds = off_exc_hi + (size_t)m;
    const size_t off_bitmap = off_seeds + (size_t)m * rows;
    const size_t off_codes = off_bitmap + (size_t)m * bw;
    if (buf_len < off_codes) return kShort;

    if (n == 0) {
        memcpy(flags_out, buf, m);
        for (size_t p = 0; p < (size_t)m; ++p)
            for (size_t r = 0; r < rows; ++r)
                q_out[p * rows + r] = buf[off_seeds + p * rows + r];
        return 0;
    }

    // per-pair prefix offsets into the variable sections
    std::vector<size_t> code_off(m + 1), exc_off(m + 1);
    code_off[0] = 0;
    exc_off[0] = 0;
    for (int p = 0; p < m; ++p) {
        size_t pc = 0;
        const uint8_t* bm = buf + off_bitmap + (size_t)p * bw;
        for (size_t i = 0; i < bw; ++i) pc += __builtin_popcount(bm[i]);
        code_off[p + 1] = code_off[p] + pc;
        const size_t ne = (size_t)buf[off_exc_lo + p] |
                          ((size_t)buf[off_exc_hi + p] << 8);
        exc_off[p + 1] = exc_off[p] + ne;
    }
    const size_t off_exc = off_codes + code_off[m];
    if (buf_len < off_exc + 4 * exc_off[m]) return kShort;

    memcpy(flags_out, buf, m);
    parallel_pairs(m, n_threads, [&](int p) {
        if (!buf[p]) return;  // exception overflow: raw fallback
        const uint8_t* seeds = buf + off_seeds + (size_t)p * rows;
        const uint8_t* bm = buf + off_bitmap + (size_t)p * bw;
        const uint8_t* codes = buf + off_codes + code_off[p];
        const uint8_t* exc = buf + off_exc + 4 * exc_off[p];
        const size_t n_exc = exc_off[p + 1] - exc_off[p];
        uint8_t* out = q_out + (size_t)p * rows * w;

        size_t e = 0;  // escapes come in ascending flat-index order
        uint32_t next_exc = n_exc > 0 ? idx24(exc) : kPadIdx;
        size_t ci = 0;  // cursor into this pair's occupied-group bytes
        for (size_t r = 0; r < rows; ++r) {
            uint8_t acc = seeds[r];
            uint8_t* orow = out + r * w;
            orow[0] = acc;
            const uint32_t flat_base = (uint32_t)(r * n);
            const size_t gbase = r * gw;
            for (size_t g = 0; g < gw; ++g) {
                const size_t gi = gbase + g;
                uint8_t byte = 0;
                if (bm[gi >> 3] & (1u << (gi & 7))) byte = codes[ci++];
                const size_t i0 = 4 * g;
                const size_t kmax = n - i0 < 4 ? n - i0 : 4;
                for (size_t k = 0; k < kmax; ++k) {
                    const size_t i = i0 + k;
                    acc = (uint8_t)(acc + kDelta[(byte >> (2 * k)) & 3]);
                    if (flat_base + (uint32_t)i == next_exc) {
                        acc = (uint8_t)(acc + exc[4 * e + 3]);
                        ++e;
                        next_exc = e < n_exc ? idx24(exc + 4 * e) : kPadIdx;
                    }
                    orow[i + 1] = acc;
                }
            }
        }
    });
    return 0;
}

// v4 LOSSLESS float32 decoder. Layout:
//   counts  8 * u32 LE        occupied-group count per stream
//   seeds   m*2*h * u32 LE    column 0, pair-major, u then v
//   streams 8 x [bitmap ceil(g_tot/8) bytes LSB-first, 4*count literal
//                group bytes]  (c-major then plane k=0..3; within a
//                stream, groups are pair-major: pair p owns
//                [p*ng, (p+1)*ng))
// out: (m, h, w, 2) float32 (little-endian host, as in wire.py). Returns
// 0, or kShort when buf_len is below the used length the counts declare.
int df_wire_unpack_v4(const uint8_t* buf, size_t buf_len, int m, int h,
                      int w, float* out, int n_threads) {
    const size_t n = w > 1 ? (size_t)(w - 1) : 0;
    const size_t seeds_off = 32;
    const size_t fixed = seeds_off + (size_t)m * 2 * h * 4;
    if (buf_len < fixed) return kShort;
    const size_t hn = (size_t)h * n;
    if (n == 0) {
        parallel_pairs(m, n_threads, [&](int p) {
            for (int c = 0; c < 2; ++c) {
                const uint8_t* sp = buf + seeds_off + ((size_t)p * 2 + c) * h * 4;
                for (int y = 0; y < h; ++y)
                    memcpy(out + ((size_t)p * h + y) * 2 + c, sp + 4 * (size_t)y, 4);
            }
        });
        return 0;
    }
    const size_t ng = (hn + 3) / 4;       // groups per (pair, comp, plane)
    const size_t g_tot = (size_t)m * ng;  // groups per stream
    const size_t bw = (g_tot + 7) / 8;    // bitmap bytes per stream
    uint32_t counts[8];
    memcpy(counts, buf, 32);

    // per-stream layout: bitmap base, codes base, and per-pair occupied-
    // group prefix (bit count before pair p's group range)
    const uint8_t* bitmaps[8];
    const uint8_t* codes[8];
    std::vector<size_t> prefix((size_t)8 * m);
    size_t o = fixed;
    for (int s = 0; s < 8; ++s) {
        bitmaps[s] = buf + o;
        o += bw;
        codes[s] = buf + o;
        o += 4 * (size_t)counts[s];
    }
    if (buf_len < o) return kShort;
    for (int s = 0; s < 8; ++s) {
        const uint8_t* bm = bitmaps[s];
        size_t acc = 0;
        size_t bit = 0;  // cursor
        for (int p = 0; p < m; ++p) {
            prefix[(size_t)s * m + p] = acc;
            const size_t end = ((size_t)p + 1) * ng;
            while (bit < end && (bit & 7)) {  // unaligned head
                acc += (bm[bit >> 3] >> (bit & 7)) & 1;
                ++bit;
            }
            while (bit + 8 <= end) {
                acc += __builtin_popcount(bm[bit >> 3]);
                bit += 8;
            }
            while (bit < end) {
                acc += (bm[bit >> 3] >> (bit & 7)) & 1;
                ++bit;
            }
        }
    }

    parallel_pairs(m, n_threads, [&](int p) {
        std::vector<uint32_t> z(hn);
        for (int c = 0; c < 2; ++c) {
            std::fill(z.begin(), z.end(), 0u);
            for (int k = 0; k < 4; ++k) {
                const int s = c * 4 + k;
                const uint8_t* bm = bitmaps[s];
                const uint8_t* cp = codes[s] + 4 * prefix[(size_t)s * m + p];
                const size_t g0 = (size_t)p * ng;
                const int shift = 8 * k;
                for (size_t g = 0; g < ng; ++g) {
                    const size_t bit = g0 + g;
                    if (!((bm[bit >> 3] >> (bit & 7)) & 1)) continue;
                    const size_t base = 4 * g;
                    const size_t lim = hn - base < 4 ? hn - base : 4;
                    for (size_t j = 0; j < lim; ++j)
                        z[base + j] |= (uint32_t)cp[j] << shift;
                    cp += 4;
                }
            }
            const uint8_t* sp = buf + seeds_off + ((size_t)p * 2 + c) * h * 4;
            for (int y = 0; y < h; ++y) {
                uint32_t cur;
                memcpy(&cur, sp + 4 * (size_t)y, 4);
                float* orow = out + ((size_t)p * h + y) * w * 2 + c;
                memcpy(orow, &cur, 4);
                const uint32_t* zr = z.data() + (size_t)y * n;
                for (size_t x = 0; x < n; ++x) {
                    const uint32_t zz = zr[x];
                    const uint32_t d = (zz >> 1) ^ (~(zz & 1u) + 1u);
                    cur += d;
                    memcpy(orow + 2 * (x + 1), &cur, 4);
                }
            }
        }
    });
    return 0;
}

}  // extern "C"
