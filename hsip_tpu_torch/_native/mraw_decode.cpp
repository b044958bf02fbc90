// Native MRAW codec: packed 10/12-bit <-> uint16, multithreaded.
//
// Host-side staging path of the framework (the TPU path ships raw packed
// bytes to HBM and unpacks on-device; this decoder serves PhotonVideo's
// host frame access and validates the device kernel). Replaces the
// reference's dependency on pyMRAW's numpy decode (reference
// src/photron/video.py:332) with a ~GB/s parallel C++ implementation.
//
// Packing (MSB-first, Photron MRAW):
//   12-bit: 3 bytes -> 2 px:  p0 = b0<<4 | b1>>4,  p1 = (b1&0xF)<<8 | b2
//   10-bit: 5 bytes -> 4 px:  p0 = b0<<2 | b1>>6,  p1 = (b1&0x3F)<<4 | b2>>4,
//                             p2 = (b2&0xF)<<6 | b3>>2, p3 = (b3&0x3)<<8 | b4
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp mraw_decode.cpp
//        -o libmraw_decode.so
// ABI: plain C functions, driven from Python via ctypes.

#include <cstdint>
#include <cstddef>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef __AVX2__
#include <immintrin.h>
#endif

extern "C" {

// Unpack 12-bit MSB-first packed bytes into uint16 pixels.
// n_pairs = number of 3-byte groups (= n_pixels / 2).
void unpack12(const uint8_t* __restrict src, uint16_t* __restrict dst,
              int64_t n_pairs) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_pairs; ++i) {
        const uint8_t* s = src + 3 * i;
        uint16_t* d = dst + 2 * i;
        d[0] = (uint16_t)((s[0] << 4) | (s[1] >> 4));
        d[1] = (uint16_t)(((s[1] & 0x0F) << 8) | s[2]);
    }
}

// Pack uint16 pixels (< 4096) into 12-bit MSB-first bytes.
void pack12(const uint16_t* __restrict src, uint8_t* __restrict dst,
            int64_t n_pairs) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_pairs; ++i) {
        const uint16_t* s = src + 2 * i;
        uint8_t* d = dst + 3 * i;
        d[0] = (uint8_t)(s[0] >> 4);
        d[1] = (uint8_t)(((s[0] & 0x0F) << 4) | (s[1] >> 8));
        d[2] = (uint8_t)(s[1] & 0xFF);
    }
}

// Unpack 10-bit MSB-first packed bytes into uint16 pixels.
// n_quads = number of 5-byte groups (= n_pixels / 4).
void unpack10(const uint8_t* __restrict src, uint16_t* __restrict dst,
              int64_t n_quads) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_quads; ++i) {
        const uint8_t* s = src + 5 * i;
        uint16_t* d = dst + 4 * i;
        d[0] = (uint16_t)((s[0] << 2) | (s[1] >> 6));
        d[1] = (uint16_t)(((s[1] & 0x3F) << 4) | (s[2] >> 4));
        d[2] = (uint16_t)(((s[2] & 0x0F) << 6) | (s[3] >> 2));
        d[3] = (uint16_t)(((s[3] & 0x03) << 8) | s[4]);
    }
}

// Pack uint16 pixels (< 1024) into 10-bit MSB-first bytes.
void pack10(const uint16_t* __restrict src, uint8_t* __restrict dst,
            int64_t n_quads) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_quads; ++i) {
        const uint16_t* s = src + 4 * i;
        uint8_t* d = dst + 5 * i;
        d[0] = (uint8_t)(s[0] >> 2);
        d[1] = (uint8_t)(((s[0] & 0x03) << 6) | (s[1] >> 4));
        d[2] = (uint8_t)(((s[1] & 0x0F) << 4) | (s[2] >> 6));
        d[3] = (uint8_t)(((s[2] & 0x3F) << 2) | (s[3] >> 8));
        d[4] = (uint8_t)(s[3] & 0xFF);
    }
}

// Fused: unpack 12-bit directly to float32 with scalar background
// subtraction clamped at zero — saves one memory round-trip when the host
// path feeds preprocessing directly.
void unpack12_bgsub_f32(const uint8_t* __restrict src, float* __restrict dst,
                        int64_t n_pairs, float background) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_pairs; ++i) {
        const uint8_t* s = src + 3 * i;
        float* d = dst + 2 * i;
        float p0 = (float)((s[0] << 4) | (s[1] >> 4)) - background;
        float p1 = (float)(((s[1] & 0x0F) << 8) | s[2]) - background;
        d[0] = p0 < 0.0f ? 0.0f : p0;
        d[1] = p1 < 0.0f ? 0.0f : p1;
    }
}

}  // extern "C"

// Payload-scan thread override. The cold-cache scans are page-fault-bound:
// threads block in fault I/O, so the useful count is an I/O-concurrency
// knob, not a core count. Foreign threads (Python thread pools) each carry
// their own OpenMP nthreads ICV, so omp_set_num_threads from the loader
// thread would NOT reach them — the scan pragmas read this global instead.
static int g_scan_threads = 0;  // 0 = OpenMP default

static inline int scan_threads() {
#ifdef _OPENMP
    return g_scan_threads > 0 ? g_scan_threads : omp_get_max_threads();
#else
    return 1;
#endif
}

// ---- The above-noise count: the empty-frame test ----------------------
//
// A pixel counts when max((float)p - background, 0) > threshold in
// float32 (reference process_videos.py:743-763). For an integer code p in
// [0, 2^bits) that rule is monotone in p, since float rounding is, so it
// equals p >= p_min: the rule is decided once a call, over every code,
// and each pixel costs one integer compare. That makes the 12-bit count a
// vector unpack-and-compare, chosen by the instruction set the library is
// built for: AVX-512 VBMI (48 packed bytes -> 32 pixels a step), AVX2
// (24 -> 16), else the scalar integer loop, which also takes each frame's
// tail. The counts are those of the float rule, bit for bit.

static inline bool counts_f32(float p, float background, float threshold) {
    float v = p - background;
    if (v < 0.0f) v = 0.0f;
    return v > threshold;
}

// The least code that counts (2^bits when none does), from the float rule
// itself over every code — NaN, a negative threshold and a background
// above the largest code need no case of their own. -1 when the rule is
// not monotone over the codes (IEEE arithmetic rules it out; the caller
// then keeps the float rule per pixel).
static int32_t least_counting_code(int bits, float background,
                                   float threshold) {
    const int32_t n = 1 << bits;
    int32_t p_min = n;
    for (int32_t p = 0; p < n; ++p) {
        const bool c = counts_f32((float)p, background, threshold);
        if (c && p_min == n) p_min = p;
        if (!c && p_min != n) return -1;
    }
    return p_min;
}

// Sum of counts(p) over the pixels of one packed frame; bytes past the
// last whole pixel group are not pixels.
template <int BITS, class Counts>
static inline int32_t count_pixels(const uint8_t* __restrict s,
                                   int64_t nbytes, Counts counts) {
    int32_t c = 0;
    if (BITS == 12) {
        for (int64_t i = 0; i < nbytes / 3; ++i) {
            const uint8_t* b = s + 3 * i;
            c += counts((b[0] << 4) | (b[1] >> 4));
            c += counts(((b[1] & 0x0F) << 8) | b[2]);
        }
    } else if (BITS == 10) {
        for (int64_t i = 0; i < nbytes / 5; ++i) {
            const uint8_t* b = s + 5 * i;
            c += counts((b[0] << 2) | (b[1] >> 6));
            c += counts(((b[1] & 0x3F) << 4) | (b[2] >> 4));
            c += counts(((b[2] & 0x0F) << 6) | (b[3] >> 2));
            c += counts(((b[3] & 0x03) << 8) | b[4]);
        }
    } else if (BITS == 16) {  // little-endian
        for (int64_t i = 0; i < nbytes / 2; ++i)
            c += counts(s[2 * i] | (s[2 * i + 1] << 8));
    } else {  // 8-bit: the bytes are the pixels
        for (int64_t i = 0; i < nbytes; ++i) c += counts(s[i]);
    }
    return c;
}

// The 12-bit vector step. Each packed pair b0 b1 b2 is permuted into the
// words (b0 b1) and (b1 b2), big-end first: the even pixel is the first
// shifted right by 4, the odd one the second masked to 12 bits. Returns
// the count over the leading bytes it covered, their number in *done.
// Every load lies inside [s, s + nbytes): the last frame of a memory map
// ends where the mapping does.
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#define COUNT12_PATH "avx512"
static inline int32_t count12_vector(const uint8_t* __restrict s,
                                     int64_t nbytes, int32_t p_min,
                                     int64_t* done) {
    alignas(64) static const uint8_t kPairs[64] = {
        1, 0, 2, 1, 4, 3, 5, 4, 7, 6, 8, 7, 10, 9, 11, 10,
        13, 12, 14, 13, 16, 15, 17, 16, 19, 18, 20, 19, 22, 21, 23, 22,
        25, 24, 26, 25, 28, 27, 29, 28, 31, 30, 32, 31, 34, 33, 35, 34,
        37, 36, 38, 37, 40, 39, 41, 40, 43, 42, 44, 43, 46, 45, 47, 46};
    const __m512i idx = _mm512_load_si512(kPairs);
    const __m512i lo12 = _mm512_set1_epi16(0x0FFF);
    const __m512i least = _mm512_set1_epi16((int16_t)p_min);
    int32_t c = 0;
    int64_t i = 0;
    for (; i + 64 <= nbytes; i += 48) {  // a 64-byte load, 48 bytes used
        const __m512i w =
            _mm512_permutexvar_epi8(idx, _mm512_loadu_si512(s + i));
        const __m512i px = _mm512_mask_blend_epi16(
            0xAAAAAAAAu, _mm512_srli_epi16(w, 4), _mm512_and_si512(w, lo12));
        c += __builtin_popcount(_mm512_cmpge_epu16_mask(px, least));
    }
    *done = i;
    return c;
}
#elif defined(__AVX2__)
#define COUNT12_PATH "avx2"
static inline int32_t count12_vector(const uint8_t* __restrict s,
                                     int64_t nbytes, int32_t p_min,
                                     int64_t* done) {
    // Four pairs a 128-bit lane: bytes [i, i+12) and [i+12, i+24).
    const __m256i idx = _mm256_setr_epi8(
        1, 0, 2, 1, 4, 3, 5, 4, 7, 6, 8, 7, 10, 9, 11, 10,
        1, 0, 2, 1, 4, 3, 5, 4, 7, 6, 8, 7, 10, 9, 11, 10);
    const __m256i lo12 = _mm256_set1_epi16(0x0FFF);
    // p >= p_min as a signed p > p_min - 1: pixels and p_min are < 2^15.
    const __m256i below = _mm256_set1_epi16((int16_t)(p_min - 1));
    int32_t bits = 0;  // two mask bits a pixel
    int64_t i = 0;
    for (; i + 28 <= nbytes; i += 24) {  // two 16-byte loads, 24 bytes used
        const __m256i raw = _mm256_inserti128_si256(
            _mm256_castsi128_si256(
                _mm_loadu_si128((const __m128i*)(s + i))),
            _mm_loadu_si128((const __m128i*)(s + i + 12)), 1);
        const __m256i w = _mm256_shuffle_epi8(raw, idx);
        const __m256i px = _mm256_blend_epi16(
            _mm256_srli_epi16(w, 4), _mm256_and_si256(w, lo12), 0xAA);
        bits += __builtin_popcount(
            _mm256_movemask_epi8(_mm256_cmpgt_epi16(px, below)));
    }
    *done = i;
    return bits / 2;
}
#else
#define COUNT12_PATH "scalar"
static inline int32_t count12_vector(const uint8_t*, int64_t, int32_t,
                                     int64_t* done) {
    *done = 0;
    return 0;
}
#endif

struct CountRule {
    int32_t p_min;  // -1: the float rule per pixel
    float background, threshold;
};

template <int BITS>
static inline int32_t count_frame(const uint8_t* __restrict s,
                                  int64_t nbytes, const CountRule& rule,
                                  bool vector) {
    const int32_t p_min = rule.p_min;
    if (p_min < 0) {
        const float bg = rule.background, thr = rule.threshold;
        return count_pixels<BITS>(
            s, nbytes, [=](int p) { return counts_f32((float)p, bg, thr); });
    }
    int64_t done = 0;
    int32_t c = 0;
    if (BITS == 12 && vector) c = count12_vector(s, nbytes, p_min, &done);
    return c + count_pixels<BITS>(s + done, nbytes - done,
                                  [=](int p) { return p >= p_min; });
}

template <int BITS>
static void count_frames(const uint8_t* __restrict src, int64_t n_frames,
                         int64_t frame_nbytes, float background,
                         float threshold, int32_t* __restrict counts,
                         bool vector) {
    const CountRule rule{least_counting_code(BITS, background, threshold),
                         background, threshold};
#pragma omp parallel for schedule(static) num_threads(scan_threads())
    for (int64_t f = 0; f < n_frames; ++f)
        counts[f] = count_frame<BITS>(src + f * frame_nbytes, frame_nbytes,
                                      rule, vector);
}

// The selected rows of one frame s, row_nbytes bytes from each of
// s + row_offsets[r], into d one after another.
static inline void copy_rows(const uint8_t* __restrict s,
                             const int64_t* __restrict row_offsets,
                             int64_t n_rows, int64_t row_nbytes,
                             uint8_t* __restrict d) {
    for (int64_t r = 0; r < n_rows; ++r) {
        const uint8_t* sr = s + row_offsets[r];
        uint8_t* dr = d + r * row_nbytes;
        for (int64_t i = 0; i < row_nbytes; ++i) dr[i] = sr[i];
    }
}

// Fused gather + count: ONE sweep over the packed payload. Per frame, a
// copy of the selected band rows and the frame's above-noise count, taken
// while the frame's bytes are cache-hot, so host staging reads the
// payload's DRAM at most once. With the vector count the sweep runs near
// the host's memory floor: on two 8-core Xeon hosts (AVX-512 VBMI), 8
// threads over a fresh mapping of a 402.7 MB recording, the whole-frame
// count ran at 27.0 and 31.9 GB/s, where the float loop ran at 16.6 and
// 18.5 and a walk that only touches each cache line and copies the rows at
// 26.7 and 49.2 (medians; PERF.md §5). So the memory traffic and the
// mapping's page faults bound it first, the vector decode second.
//
// counts[f] is min(count, cap). A caller that needs exact counts passes a
// cap above a frame's pixels: no count can reach it, so each frame is
// counted whole, in one segment, and each thread takes one contiguous
// range of frames. That loop is kept apart: with its exact counts taken
// by the capped loop below instead, the per-file route ran at 0.62 times
// its frames/s on the H100's host (PERF.md §6). A caller that only asks
// whether a frame's count reaches cap
// (the empty-frame test) passes that count, and most of a lit frame's
// bytes are never read: the band's distinct rows are counted first,
// while the copy has them in cache, and the frame's other rows follow in
// order only while the count is below cap, stopping at the first row
// boundary where it reaches cap. Contiguous rows of the band are counted
// as one segment, the other rows one row at a time. Rows must be whole
// pixel groups (byte-aligned rows), so a segment's count is that of its
// pixels and every vector load stays inside its segment. Returns the
// frames whose count stopped before their last row. The capped loop is
// dynamic: a dark frame costs several lit ones, and dark frames come in
// runs.
struct RowRun {
    int64_t first, n;
};

static void row_runs(const std::vector<char>& take, char want,
                     std::vector<RowRun>* runs) {
    const int64_t h = (int64_t)take.size();
    for (int64_t r = 0; r < h;) {
        if (take[r] != want) { ++r; continue; }
        int64_t e = r;
        while (e < h && take[e] == want) ++e;
        runs->push_back({r, e - r});
        r = e;
    }
}

template <int BITS>
static int64_t gather_count(
        const uint8_t* __restrict src, int64_t n_frames, int64_t frame_nbytes,
        const int64_t* __restrict row_offsets, int64_t n_rows,
        int64_t row_nbytes, float background, float threshold, int32_t cap,
        uint8_t* __restrict dst, int32_t* __restrict counts) {
    const CountRule rule{least_counting_code(BITS, background, threshold),
                         background, threshold};
    if ((int64_t)cap > frame_nbytes * 8 / BITS) {  // exact counts
#pragma omp parallel for schedule(static) num_threads(scan_threads())
        for (int64_t f = 0; f < n_frames; ++f) {
            const uint8_t* s = src + f * frame_nbytes;
            counts[f] = count_frame<BITS>(s, frame_nbytes, rule, true);
            copy_rows(s, row_offsets, n_rows, row_nbytes,
                      dst + f * n_rows * row_nbytes);
        }
        return 0;
    }
    const int64_t h = frame_nbytes / row_nbytes;
    std::vector<char> in_band(h, 0);
    for (int64_t r = 0; r < n_rows; ++r) in_band[row_offsets[r] / row_nbytes] = 1;
    std::vector<RowRun> band, other;
    row_runs(in_band, 1, &band);
    row_runs(in_band, 0, &other);
    int64_t stopped = 0;
#pragma omp parallel for schedule(dynamic, 8) num_threads(scan_threads()) \
    reduction(+ : stopped)
    for (int64_t f = 0; f < n_frames; ++f) {
        const uint8_t* s = src + f * frame_nbytes;
        copy_rows(s, row_offsets, n_rows, row_nbytes,
                  dst + f * n_rows * row_nbytes);
        int32_t c = 0;
        int64_t left = h;  // rows not counted
        for (const RowRun& run : band) {
            if (c >= cap) break;
            c += count_frame<BITS>(s + run.first * row_nbytes,
                                   run.n * row_nbytes, rule, true);
            left -= run.n;
        }
        for (const RowRun& run : other) {
            for (int64_t r = run.first; r < run.first + run.n && c < cap;
                 ++r, --left)
                c += count_frame<BITS>(s + r * row_nbytes, row_nbytes, rule,
                                       true);
        }
        stopped += left > 0;
        counts[f] = c < cap ? c : cap;
    }
    return stopped;
}

extern "C" {

// counts[f] = #pixels of frame f that count (see above). The fused
// gather+count below is the staging path; these serve the two-pass
// degrade and MRAWReader.count_above.
#define COUNT_ABOVE(BITS)                                                   \
void count_above##BITS(const uint8_t* __restrict src, int64_t n_frames,     \
                       int64_t frame_nbytes, float background,              \
                       float threshold, int32_t* __restrict counts) {       \
    count_frames<BITS>(src, n_frames, frame_nbytes, background, threshold,  \
                       counts, true);                                       \
}
COUNT_ABOVE(8)
COUNT_ABOVE(10)
COUNT_ABOVE(12)
COUNT_ABOVE(16)

// The same counts by the scalar integer loop alone, for any depth: what
// the vector path is held against.
void count_above_scalar(const uint8_t* __restrict src, int64_t n_frames,
                        int64_t frame_nbytes, int32_t bits, float background,
                        float threshold, int32_t* __restrict counts) {
    switch (bits) {
        case 8: count_frames<8>(src, n_frames, frame_nbytes, background,
                                threshold, counts, false); break;
        case 10: count_frames<10>(src, n_frames, frame_nbytes, background,
                                  threshold, counts, false); break;
        case 12: count_frames<12>(src, n_frames, frame_nbytes, background,
                                  threshold, counts, false); break;
        case 16: count_frames<16>(src, n_frames, frame_nbytes, background,
                                  threshold, counts, false); break;
    }
}

// Which path counts 12-bit pixels in this build: "avx512", "avx2" or
// "scalar". Every other depth takes the scalar integer loop.
const char* native_count_path() { return COUNT12_PATH; }

// The band rows, min(count, cap) per frame, and the frames whose count
// stopped before their last row (see gather_count above). frame_nbytes is
// a whole number of rows; INT32_MAX as cap gives exact counts.
#define GATHER_COUNT(BITS)                                                  \
int64_t gather_count##BITS(                                                 \
        const uint8_t* __restrict src, int64_t n_frames,                    \
        int64_t frame_nbytes, const int64_t* __restrict row_offsets,        \
        int64_t n_rows, int64_t row_nbytes, float background,               \
        float threshold, int32_t cap, uint8_t* __restrict dst,              \
        int32_t* __restrict counts) {                                       \
    return gather_count<BITS>(src, n_frames, frame_nbytes, row_offsets,     \
                              n_rows, row_nbytes, background, threshold,    \
                              cap, dst, counts);                            \
}
GATHER_COUNT(8)
GATHER_COUNT(10)
GATHER_COUNT(12)
GATHER_COUNT(16)

// Gather selected byte-aligned rows from every frame of a packed payload:
// dst[f, r, :] = src[f * frame_nbytes + row_offsets[r] : + row_nbytes].
// The band-staging hot path. The copy is memory-bandwidth bound, so the
// win over numpy's single-threaded fancy-index gather is modest when the
// host is idle (~1.2x) but grows under CPU contention from transfer/
// render threads, which is the steady state of the pipeline.
void gather_rows(const uint8_t* __restrict src, int64_t n_frames,
                 int64_t frame_nbytes, const int64_t* __restrict row_offsets,
                 int64_t n_rows, int64_t row_nbytes,
                 uint8_t* __restrict dst) {
#pragma omp parallel for schedule(static) num_threads(scan_threads())
    for (int64_t f = 0; f < n_frames; ++f) {
        const uint8_t* s = src + f * frame_nbytes;
        copy_rows(s, row_offsets, n_rows, row_nbytes,
                  dst + f * n_rows * row_nbytes);
    }
}

int native_num_threads() {
    // Effective thread count of the payload scans (the override, else the
    // OpenMP default of the calling thread).
    return scan_threads();
}

void native_set_num_threads(int n) {
    // Sets the payload-scan thread override (see g_scan_threads above;
    // measured 5x cold-cache speedup at 16 threads on a 1-core VM,
    // warm-cache time unchanged). Reaches ALL calling threads, unlike
    // omp_set_num_threads whose ICV is per-thread for foreign pthreads.
    if (n > 0) g_scan_threads = n;
}

}  // extern "C"
