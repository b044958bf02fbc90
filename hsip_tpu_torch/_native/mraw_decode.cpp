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

#ifdef _OPENMP
#include <omp.h>
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

// Fused decode + background-subtract + above-threshold COUNT per frame,
// without materializing pixels: one pass over the packed payload. Serves
// the empty-frame test so only centerline-band bytes ever cross PCIe.
// counts[f] = #pixels in frame f with max(pixel - background, 0) > threshold.
void count_above12(const uint8_t* __restrict src, int64_t n_frames,
                   int64_t frame_nbytes, float background, float threshold,
                   int32_t* __restrict counts) {
    const int64_t pairs_per_frame = frame_nbytes / 3;
#pragma omp parallel for schedule(static) num_threads(scan_threads())
    for (int64_t f = 0; f < n_frames; ++f) {
        const uint8_t* s = src + f * frame_nbytes;
        int32_t c = 0;
        for (int64_t i = 0; i < pairs_per_frame; ++i) {
            const uint8_t* b = s + 3 * i;
            float p0 = (float)((b[0] << 4) | (b[1] >> 4)) - background;
            float p1 = (float)(((b[1] & 0x0F) << 8) | b[2]) - background;
            if (p0 < 0.0f) p0 = 0.0f;
            if (p1 < 0.0f) p1 = 0.0f;
            c += (p0 > threshold) + (p1 > threshold);
        }
        counts[f] = c;
    }
}

// 10-bit variant of the fused count (5 bytes -> 4 px).
void count_above10(const uint8_t* __restrict src, int64_t n_frames,
                   int64_t frame_nbytes, float background, float threshold,
                   int32_t* __restrict counts) {
    const int64_t quads_per_frame = frame_nbytes / 5;
#pragma omp parallel for schedule(static) num_threads(scan_threads())
    for (int64_t f = 0; f < n_frames; ++f) {
        const uint8_t* s = src + f * frame_nbytes;
        int32_t c = 0;
        for (int64_t i = 0; i < quads_per_frame; ++i) {
            const uint8_t* b = s + 5 * i;
            uint16_t p[4] = {
                (uint16_t)((b[0] << 2) | (b[1] >> 6)),
                (uint16_t)(((b[1] & 0x3F) << 4) | (b[2] >> 4)),
                (uint16_t)(((b[2] & 0x0F) << 6) | (b[3] >> 2)),
                (uint16_t)(((b[3] & 0x03) << 8) | b[4]),
            };
            for (int j = 0; j < 4; ++j) {
                float v = (float)p[j] - background;
                if (v < 0.0f) v = 0.0f;
                c += (v > threshold);
            }
        }
        counts[f] = c;
    }
}

// 16-bit little-endian variant of the fused count.
void count_above16(const uint8_t* __restrict src, int64_t n_frames,
                   int64_t frame_nbytes, float background, float threshold,
                   int32_t* __restrict counts) {
    const int64_t px_per_frame = frame_nbytes / 2;
#pragma omp parallel for schedule(static) num_threads(scan_threads())
    for (int64_t f = 0; f < n_frames; ++f) {
        const uint8_t* s = src + f * frame_nbytes;
        int32_t c = 0;
        for (int64_t i = 0; i < px_per_frame; ++i) {
            uint16_t p = (uint16_t)(s[2 * i] | (s[2 * i + 1] << 8));
            float v = (float)p - background;
            if (v < 0.0f) v = 0.0f;
            c += (v > threshold);
        }
        counts[f] = c;
    }
}

// 8-bit variant of the fused count: payload bytes ARE the pixels.
void count_above8(const uint8_t* __restrict src, int64_t n_frames,
                  int64_t frame_nbytes, float background, float threshold,
                  int32_t* __restrict counts) {
#pragma omp parallel for schedule(static) num_threads(scan_threads())
    for (int64_t f = 0; f < n_frames; ++f) {
        const uint8_t* s = src + f * frame_nbytes;
        int32_t c = 0;
        for (int64_t i = 0; i < frame_nbytes; ++i) {
            float v = (float)s[i] - background;
            if (v < 0.0f) v = 0.0f;
            c += (v > threshold);
        }
        counts[f] = c;
    }
}

// ---- Fused gather + count: ONE pass over the packed payload ------------
//
// Per frame, compute the above-noise pixel count over the WHOLE frame
// (the empty-frame test, reference process_videos.py:743-763) AND copy the
// selected band rows — so host staging touches the payload's DRAM once
// instead of twice (count_above* then gather_rows). The row copies run
// right after the frame's count pass while its bytes are still cache-hot.
// counts[f] = #pixels with max(pixel - background, 0) > threshold.

#define FUSED_GATHER_COUNT(NAME, COUNT_FRAME)                                \
void NAME(const uint8_t* __restrict src, int64_t n_frames,                   \
          int64_t frame_nbytes, const int64_t* __restrict row_offsets,       \
          int64_t n_rows, int64_t row_nbytes, float background,              \
          float threshold, uint8_t* __restrict dst,                          \
          int32_t* __restrict counts) {                                      \
    _Pragma("omp parallel for schedule(static) num_threads(scan_threads())") \
    for (int64_t f = 0; f < n_frames; ++f) {                                 \
        const uint8_t* s = src + f * frame_nbytes;                           \
        counts[f] = COUNT_FRAME(s, frame_nbytes, background, threshold);     \
        uint8_t* d = dst + f * n_rows * row_nbytes;                          \
        for (int64_t r = 0; r < n_rows; ++r) {                               \
            const uint8_t* sr = s + row_offsets[r];                          \
            uint8_t* dr = d + r * row_nbytes;                                \
            for (int64_t i = 0; i < row_nbytes; ++i) dr[i] = sr[i];          \
        }                                                                    \
    }                                                                        \
}

static inline int32_t count_frame12(const uint8_t* __restrict s,
                                    int64_t frame_nbytes, float background,
                                    float threshold) {
    const int64_t pairs = frame_nbytes / 3;
    int32_t c = 0;
    for (int64_t i = 0; i < pairs; ++i) {
        const uint8_t* b = s + 3 * i;
        float p0 = (float)((b[0] << 4) | (b[1] >> 4)) - background;
        float p1 = (float)(((b[1] & 0x0F) << 8) | b[2]) - background;
        if (p0 < 0.0f) p0 = 0.0f;
        if (p1 < 0.0f) p1 = 0.0f;
        c += (p0 > threshold) + (p1 > threshold);
    }
    return c;
}

static inline int32_t count_frame10(const uint8_t* __restrict s,
                                    int64_t frame_nbytes, float background,
                                    float threshold) {
    const int64_t quads = frame_nbytes / 5;
    int32_t c = 0;
    for (int64_t i = 0; i < quads; ++i) {
        const uint8_t* b = s + 5 * i;
        uint16_t p[4] = {
            (uint16_t)((b[0] << 2) | (b[1] >> 6)),
            (uint16_t)(((b[1] & 0x3F) << 4) | (b[2] >> 4)),
            (uint16_t)(((b[2] & 0x0F) << 6) | (b[3] >> 2)),
            (uint16_t)(((b[3] & 0x03) << 8) | b[4]),
        };
        for (int j = 0; j < 4; ++j) {
            float v = (float)p[j] - background;
            if (v < 0.0f) v = 0.0f;
            c += (v > threshold);
        }
    }
    return c;
}

static inline int32_t count_frame16(const uint8_t* __restrict s,
                                    int64_t frame_nbytes, float background,
                                    float threshold) {
    const int64_t px = frame_nbytes / 2;
    int32_t c = 0;
    for (int64_t i = 0; i < px; ++i) {
        uint16_t p = (uint16_t)(s[2 * i] | (s[2 * i + 1] << 8));
        float v = (float)p - background;
        if (v < 0.0f) v = 0.0f;
        c += (v > threshold);
    }
    return c;
}

static inline int32_t count_frame8(const uint8_t* __restrict s,
                                   int64_t frame_nbytes, float background,
                                   float threshold) {
    int32_t c = 0;
    for (int64_t i = 0; i < frame_nbytes; ++i) {
        float v = (float)s[i] - background;
        if (v < 0.0f) v = 0.0f;
        c += (v > threshold);
    }
    return c;
}

FUSED_GATHER_COUNT(gather_count12, count_frame12)
FUSED_GATHER_COUNT(gather_count10, count_frame10)
FUSED_GATHER_COUNT(gather_count16, count_frame16)
FUSED_GATHER_COUNT(gather_count8, count_frame8)

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
        uint8_t* d = dst + f * n_rows * row_nbytes;
        for (int64_t r = 0; r < n_rows; ++r) {
            const uint8_t* sr = s + row_offsets[r];
            uint8_t* dr = d + r * row_nbytes;
            for (int64_t i = 0; i < row_nbytes; ++i) dr[i] = sr[i];
        }
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
