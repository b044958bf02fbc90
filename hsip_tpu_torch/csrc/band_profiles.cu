// Fused band preprocess: frame difference -> threshold -> k x k grey
// opening -> separable Gaussian -> Sobel(axis=1), np.gradient and the
// blurred center row, for every frame of a batch of centerline bands.
//
// Replaces hsip_tpu/kernels/pallas_preprocess.py::pallas_band_profiles
// (kernel body _make_kernel, helpers _reflect_pad_w, _open_rows, _open_w).
// Same contract: band (N, B, W) float32 with B = 2*band_margin(k, sigma)+1,
// prior (N,) int32 (clamped to [0, N-1]), outputs 3 x (N, W) float32; the
// caller zeroes the rows that have no prior.
//
// What bounds it on Hopper: bytes, then shared-memory reads. The function
// reads the (N, B, W) band once and writes 3 x (N, W) lines; its arithmetic
// is a few dozen flops a band element, far below the card's flop/byte
// balance. The three passes along W read shared memory k, k and ntaps times
// an element, about 0.65 G floats at N=2048, B=19, W=1024, which the SMs'
// shared-memory ports serve in about as long as HBM takes for the band.
//
// So the kernel has to read each band once, keep the loads streaming
// under the compute, and spend its instructions on the taps, not on
// index arithmetic or barriers:
//
// * A block walks a run of consecutive frames of one column tile (grid:
//   column tiles x frame runs, runs sized so that the grid fills the card
//   about once). The raw band tile of frame n stays in shared memory and
//   is frame n+1's prior when prior[n+1] == n, as on the main path; any
//   other prior (the first frame of a run, a clamped -1, a non-adjacent
//   one) is loaded into a separate prior tile. Each band is read about once.
// * The next frame's tiles load while the current one computes: cp.async,
//   16-byte copies where the rows allow (W % 4 == 0, an aligned band), else
//   4-byte copies, issued as soon as the frame's first stage has read the
//   slot they overwrite, and awaited (cp.async.wait_group) at the top of
//   the next frame.
// * No division or modulo per element. A thread owns one column of a stage
//   and walks down its rows. Reflect is resolved once per block: a table
//   of each tile column's mirror image in the image (the triangle wave of
//   period 2W, also for W narrower than the halo) drives the loads of
//   out-of-image columns, and after each stage a tile at an image edge
//   fills its out-of-image columns with the mirrored values of that
//   stage's own output. The tap loops then read straight offsets.
// * The passes along rows (VALID) run in registers as sliding windows down
//   each thread's column, fused with the pass along W that feeds them: the
//   erosion, the dilation and the Gaussian each write one buffer, so a
//   frame has four barriers (seven in a tile at an image edge).
// * Templated on (k, ntaps): the config default (3, 13) is its own
//   instantiation with every loop unrolled; any other pair runs one
//   instantiation with runtime counts, whose passes along rows reduce in
//   place down the thread's own column of shared memory. Run at (3, 13)
//   (hsip_band_profiles_probe), that one takes three times as long.
//
// Measured on an H100: about 0.25 ms at N=2048, B=19, W=1024, a fifth of
// the byte bound, its tiles streaming at a quarter of the HBM rate; the
// passes' shared loads and arithmetic hold it there (PERF.md).
//
// Layout (the wrapper does not copy it): TILE = 128 output columns a
// block, a halo of HP = ceil4((k - 1) + r_gauss + 1) columns a side, rows
// of S = TILE + 2*HP floats. Shared memory: three raw tiles (two frame
// slots and the prior tile, B rows each), the erosion and dilation buffers,
// the taps and the mirror table; 55.2 KB at the defaults, so four blocks
// share an SM. The launcher returns BAND_TOO_LARGE when a (k, sigma) needs
// more.
//
// Exactness: built with -fmad=false, and every sum keeps the plain chain's
// order (out = out + t_j * x_j, left to right; (b0 + 2*b1) + b2;
// (c[j+1] - c[j-1]) * 0.5), so the result rounds as the plain PyTorch
// chain does, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define TILE 128       // output columns of a block
#define NT 160         // threads of a block: covers a stage's TILE + 2*halo columns
#define LOAD_CHUNKS 40 // 16-byte chunks of a row one load pass covers
#define LOAD_ROWS (NT / LOAD_CHUNKS)
#define MAX_TAPS 129
#define MIN_RUN 8      // frames a block walks at least
#define SMEM_LIMIT 232448  // bytes of shared memory a Hopper block may use
#define BAND_TOO_LARGE (-1)  // launcher: the band does not fit a block

struct BandArgs {
  const float* band;
  const int* prior;
  float* sobel;
  float* grad;
  float* inten;
  int n, w, k, ntaps;
  int run;  // frames of a block
  int hp;   // halo columns a side, a multiple of 4
  int s;    // row stride of a tile buffer: TILE + 2*hp
  int vec;  // 1: 16-byte copies of in-image chunks
  float thresh;
  // When set: receives the bytes of band tiles the blocks copy from device
  // memory (hsip_band_profiles_probe); null on the main path.
  unsigned long long* loaded;
  float taps[MAX_TAPS];
};

// ---- cp.async ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The image column a column maps to under scipy 'reflect' (numpy
// 'symmetric'): mirror until inside. Once per tile column, not per element.
__device__ __forceinline__ int reflect_col(int c, int w) {
  while (c < 0 || c >= w) c = c < 0 ? -1 - c : 2 * w - 1 - c;
  return c;
}

// Start the copy of one frame's B x S raw tile (image columns base ..
// base + S - 1, each out-of-image column from its mirror image `src`).
// Thread (lr, lc) takes rows lr, lr + LOAD_ROWS, ... and chunks lc,
// lc + LOAD_CHUNKS, ... of 4 columns. Returns the thread's copies, in
// chunks of 16 bytes.
__device__ __forceinline__ int load_tile(const BandArgs& a, int frame, int B,
                                         int base, const int* src, float* dst,
                                         int lr, int lc) {
  const int W = a.w, S = a.s;
  const float* rows = a.band + (size_t)frame * B * W;
  int chunks = 0;
  for (int r = lr; r < B; r += LOAD_ROWS) {
    const float* g = rows + (size_t)r * W;
    float* d = dst + r * S;
    for (int j = 4 * lc; j < S; j += 4 * LOAD_CHUNKS) {
      const int c = base + j;
      if (a.vec && c >= 0 && c + 3 < W) {
        cp_async16(d + j, g + c);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(d + j + q, g + src[j + q]);
      }
      ++chunks;
    }
  }
  return chunks;
}

// Fill the out-of-image columns of [lo, hi) in `rows` rows of a buffer
// with the mirrored values of its in-image columns.
__device__ __forceinline__ void mirror_fill(float* buf, int rows, int S, int base,
                                            const int* src, int lo, int hi, int W) {
  for (int e = threadIdx.x; e < S; e += NT) {
    const int c = base + e;
    if (c >= lo && c < hi && (c < 0 || c >= W)) {
      const int from = src[e] - base;
      for (int r = 0; r < rows; ++r) buf[r * S + e] = buf[r * S + from];
    }
  }
}

// Thresholded frame difference at a tile element.
struct DiffIn {
  const float* cur;
  const float* pri;
  float thresh;
  __device__ __forceinline__ float operator()(int i) const {
    const float d = cur[i] - pri[i];
    return d < thresh ? 0.0f : d;
  }
};
struct BufIn {
  const float* x;
  __device__ __forceinline__ float operator()(int i) const { return x[i]; }
};

template <bool MAX>
__device__ __forceinline__ float extremum(float a, float b) {
  return MAX ? fmaxf(a, b) : fminf(a, b);
}

// One column of a grey erosion (MAX = false) or dilation: k taps along W
// starting `left` columns to the left, over `rows` input rows, then k rows
// down (VALID) into `out`'s rows - k + 1 rows. K > 0: a register window;
// K == 0 (runtime k): the pass along W lands in `out`'s own column (rows
// rows of it) and the rows reduce in place there.
template <int K, bool MAX, class In>
__device__ __forceinline__ void extremum_column(const In& in, float* out, int e,
                                                int k, int rows, int left, int S) {
  if constexpr (K > 0) {
    float win[K];
#pragma unroll
    for (int r = 0; r < rows; ++r) {
      const int i = r * S + e - left;
      float v = in(i);
#pragma unroll
      for (int o = 1; o < K; ++o) v = extremum<MAX>(v, in(i + o));
#pragma unroll
      for (int o = 0; o + 1 < K; ++o) win[o] = win[o + 1];
      win[K - 1] = v;
      if (r >= K - 1) {
        float m = win[0];
#pragma unroll
        for (int o = 1; o < K; ++o) m = extremum<MAX>(m, win[o]);
        out[(r - K + 1) * S + e] = m;
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const int i = r * S + e - left;
      float v = in(i);
      for (int o = 1; o < k; ++o) v = extremum<MAX>(v, in(i + o));
      out[r * S + e] = v;
    }
    for (int r = 0; r + k <= rows; ++r) {
      float m = out[r * S + e];
      for (int o = 1; o < k; ++o) m = extremum<MAX>(m, out[(r + o) * S + e]);
      out[r * S + e] = m;
    }
  }
}

// One column of the separable Gaussian over the ntaps + 2 rows of `y`:
// along W, then down the rows into three accumulators (output row i takes
// tap j at row i + j, taps in order); writes the smoothed Sobel row
// (b0 + 2*b1) + b2 and the center row b1 to rows 0 and 1 of `z`.
template <int NTAPS>
__device__ __forceinline__ void blur_column(const BandArgs& a, const float* tap_s,
                                            const float* y, float* z, int e,
                                            int ntaps, int S) {
  const int R = (ntaps - 1) / 2;
  auto tap = [&](int j) { return NTAPS > 0 ? a.taps[j] : tap_s[j]; };
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
#pragma unroll
  for (int r = 0; r < ntaps + 2; ++r) {
    const float* yr = y + r * S + e - R;
    float g = tap(0) * yr[0];
#pragma unroll
    for (int j = 1; j < ntaps; ++j) g = g + tap(j) * yr[j];
    if (r == 0) o0 = tap(0) * g;
    else if (r < ntaps) o0 = o0 + tap(r) * g;
    if (r == 1) o1 = tap(0) * g;
    else if (r > 1 && r <= ntaps) o1 = o1 + tap(r - 1) * g;
    if (r == 2) o2 = tap(0) * g;
    else if (r > 2) o2 = o2 + tap(r - 2) * g;
  }
  z[e] = (o0 + 2.0f * o1) + o2;
  z[S + e] = o1;
}

template <int K, int NTAPS>
__global__ void __launch_bounds__(NT, 4)
band_profiles_kernel(const __grid_constant__ BandArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int k = K > 0 ? K : a.k;
  const int ntaps = NTAPS > 0 ? NTAPS : a.ntaps;
  const int R = (ntaps - 1) / 2;
  const int H = k + R;  // (k - 1) + R + 1 columns of halo a stage chain needs
  const int B = 2 * H + 1, B1 = B - k + 1, B2 = B1 - k + 1;
  const int W = a.w, S = a.s, HP = a.hp;
  const int xrows = K > 0 ? B1 : B;   // erosion buffer
  const int yrows = K > 0 ? B2 : B1;  // dilation buffer
  float* slot0 = smem;
  float* slot1 = slot0 + B * S;
  float* pri_tile = slot1 + B * S;
  float* X = pri_tile + B * S;
  float* Y = X + xrows * S;
  float* tap_s = Y + yrows * S;
  int* src = (int*)(tap_s + MAX_TAPS);

  const int tid = threadIdx.x;
  const int lr = tid / LOAD_CHUNKS, lc = tid - lr * LOAD_CHUNKS;
  const int c0 = blockIdx.x * TILE;
  const int base = c0 - HP;  // image column of buffer column 0
  const int hi_out = min(W, c0 + TILE);
  const int n0 = blockIdx.y * a.run;
  const int n1 = min(a.n, n0 + a.run);
  // Erosion and dilation window offsets (scipy centers an even window
  // left for erosion and right for dilation).
  const int le_e = k / 2;
  const int le_d = k - 1 - k / 2, re_d = k / 2;
  // Each stage's image columns; its in-image part is computed.
  const int e_lo = c0 - (1 + R + le_d), e_hi = hi_out + 1 + R + re_d;
  const int d_lo = c0 - 1 - R, d_hi = hi_out + 1 + R;
  const int g_lo = c0 - 1, g_hi = hi_out + 1;
  const bool edge = c0 < H || hi_out + H > W;  // block-uniform

  for (int e = tid; e < S; e += NT) src[e] = reflect_col(base + e, W);
  if (NTAPS == 0)
    for (int j = tid; j < ntaps; j += NT) tap_s[j] = a.taps[j];
  __syncthreads();

  auto clamp_frame = [&](int p) { return p < 0 ? 0 : (p >= a.n ? a.n - 1 : p); };
  unsigned long long chunks = 0;  // 16-byte chunks this thread copied
  chunks += load_tile(a, n0, B, base, src, slot0, lr, lc);
  chunks += load_tile(a, clamp_frame(a.prior[n0]), B, base, src, pri_tile, lr, lc);
  cp_async_commit();

  for (int n = n0; n < n1; ++n) {
    const int i = n - n0;
    const float* cur = (i & 1) ? slot1 : slot0;
    float* other = (i & 1) ? slot0 : slot1;  // frame n-1, then frame n+1
    const bool adjacent = i > 0 && a.prior[n] == n - 1;
    const float* pri = adjacent ? other : pri_tile;
    cp_async_wait_all();
    __syncthreads();

    // Erosion: the diff's B rows along W, then down the rows -> X (B1 rows).
    const DiffIn diff{cur, pri, a.thresh};
    for (int c = max(0, e_lo) + tid; c < min(W, e_hi); c += NT)
      extremum_column<K, false>(diff, X, c - base, k, B, le_e, S);
    __syncthreads();

    // Frame n's prior tile and frame n-1's slot are read no more: start
    // frame n+1's loads, to land while this frame computes.
    if (n + 1 < n1) {
      chunks += load_tile(a, n + 1, B, base, src, other, lr, lc);
      if (a.prior[n + 1] != n)
        chunks += load_tile(a, clamp_frame(a.prior[n + 1]), B, base, src,
                            pri_tile, lr, lc);
      cp_async_commit();
    }
    if (edge) {
      mirror_fill(X, B1, S, base, src, e_lo, e_hi, W);
      __syncthreads();
    }

    // Dilation: X along W, then down the rows -> Y (B2 rows).
    for (int c = max(0, d_lo) + tid; c < min(W, d_hi); c += NT)
      extremum_column<K, true>(BufIn{X}, Y, c - base, k, B1, le_d, S);
    __syncthreads();
    if (edge) {
      mirror_fill(Y, B2, S, base, src, d_lo, d_hi, W);
      __syncthreads();
    }

    // Gaussian: Y along W and down the rows -> X rows 0 (smoothed) and 1
    // (center).
    for (int c = max(0, g_lo) + tid; c < min(W, g_hi); c += NT)
      blur_column<NTAPS>(a, tap_s, Y, X, c - base, ntaps, S);
    __syncthreads();
    if (edge) {
      mirror_fill(X, 2, S, base, src, g_lo, g_hi, W);
      __syncthreads();
    }

    // Outputs: Sobel onto the center row, np.gradient, intensity. The next
    // frame's first barrier keeps its erosion from overwriting X before
    // every thread has read it.
    const float* sm = X;
    const float* b1 = X + S;
    for (int c = c0 + tid; c < hi_out; c += NT) {
      const int e = c - base;
      float g;
      if (c == 0) {
        g = b1[e + 1] - b1[e];
      } else if (c == W - 1) {
        g = b1[e] - b1[e - 1];
      } else {
        g = (b1[e + 1] - b1[e - 1]) * 0.5f;
      }
      const size_t o = (size_t)n * W + c;
      a.sobel[o] = sm[e + 1] - sm[e - 1];
      a.grad[o] = g;
      a.inten[o] = b1[e];
    }
  }

  if (a.loaded) {  // one atomic a warp
#pragma unroll
    for (int d = 16; d > 0; d /= 2) chunks += __shfl_down_sync(0xffffffffu, chunks, d);
    if ((tid & 31) == 0) atomicAdd(a.loaded, 16ull * chunks);
  }
}

// A launch's plan: which instantiation, the tile layout, the frame run and
// the grid.
struct BandPlan {
  bool fixed;  // the (3, 13) instantiation
  int hp, s, run, tiles, runs, per_sm;
  size_t smem;
};

// The SM count and resident blocks an SM of one instantiation at one
// shared-memory size on one device, asked of the driver once per such
// triple (which then also lifts the instantiation's shared-memory limit to
// SMEM_LIMIT), not on every launch.
struct Occupancy {
  int dev;
  bool fixed;
  size_t smem;
  int sms, per_sm;
};
static std::mutex occupancy_mu;
static Occupancy occupancy_seen[64];
static int occupancy_count = 0;

static cudaError_t occupancy(bool fixed, size_t smem, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(occupancy_mu);
  for (int i = 0; i < occupancy_count; ++i) {
    const Occupancy& o = occupancy_seen[i];
    if (o.dev == dev && o.fixed == fixed && o.smem == smem) {
      *sms = o.sms;
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  void (*kernel)(BandArgs) =
      fixed ? band_profiles_kernel<3, 13> : band_profiles_kernel<0, 0>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT, smem);
  if (err == cudaSuccess && occupancy_count < 64)
    occupancy_seen[occupancy_count++] = {dev, fixed, smem, *sms, *per_sm};
  return err;
}

// Fills `p` for a launch on the current device; `runtime_counts` takes the
// runtime-count instantiation also for (3, 13). Returns 0, a cudaError_t,
// or BAND_TOO_LARGE (-1) when the band's halo exceeds the tile or its
// buffers exceed a block's shared memory.
static int band_plan(int n, int b, int w, int k, int ntaps, bool runtime_counts,
                     BandPlan* p) {
  if (n <= 0 || w < 2 || k < 1 || ntaps < 1 || ntaps > MAX_TAPS ||
      ntaps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const int h = k + (ntaps - 1) / 2;
  if (b != 2 * h + 1) return (int)cudaErrorInvalidValue;
  if (h > TILE) return BAND_TOO_LARGE;
  p->fixed = !runtime_counts && k == 3 && ntaps == 13;  // the config default
  p->hp = (h + 3) & ~3;
  p->s = TILE + 2 * p->hp;
  const int b1 = b - k + 1, b2 = b1 - k + 1;
  const size_t floats =
      (size_t)p->s * (3 * b + (p->fixed ? b1 + b2 : b + b1)) + MAX_TAPS;
  p->smem = floats * sizeof(float) + (size_t)p->s * sizeof(int);
  if (p->smem > SMEM_LIMIT) return BAND_TOO_LARGE;
  int sms = 0;
  const cudaError_t err = occupancy(p->fixed, p->smem, &sms, &p->per_sm);
  if (err != cudaSuccess) return (int)err;
  if (p->per_sm < 1) return BAND_TOO_LARGE;
  // Frame runs sized so that the grid fills the card about once; a run of
  // at least MIN_RUN frames, so that most priors come from the slot.
  p->tiles = (w + TILE - 1) / TILE;
  const int slots = sms * p->per_sm / p->tiles;
  const int runs_per_tile = slots > 1 ? slots : 1;
  const int run = (n + runs_per_tile - 1) / runs_per_tile;
  const int run_min = (n + 65534) / 65535;  // grid.y limit
  p->run = run > MIN_RUN ? run : MIN_RUN;
  if (p->run < run_min) p->run = run_min;
  p->runs = (n + p->run - 1) / p->run;
  return 0;
}

// The plan of a launch at these sizes, for callers that report or check
// it: out = {TILE, row stride, frames a run, column tiles, frame runs,
// blocks an SM}. Returns as band_plan.
extern "C" int hsip_band_profiles_plan(int n, int b, int w, int k, int ntaps,
                                       int* out) {
  BandPlan p;
  const int err = band_plan(n, b, w, k, ntaps, false, &p);
  if (err != 0) return err;
  const int v[6] = {TILE, p.s, p.run, p.tiles, p.runs, p.per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

static int band_launch(const void* band, const void* prior, void* sobel,
                       void* grad, void* inten, int n, int b, int w, int k,
                       int ntaps, const void* taps, float thresh, void* stream,
                       unsigned long long* loaded, bool runtime_counts) {
  BandPlan p;
  const int err = band_plan(n, b, w, k, ntaps, runtime_counts, &p);
  if (err != 0) return err;
  BandArgs a;
  a.band = (const float*)band;
  a.prior = (const int*)prior;
  a.sobel = (float*)sobel;
  a.grad = (float*)grad;
  a.inten = (float*)inten;
  a.n = n;
  a.w = w;
  a.k = k;
  a.ntaps = ntaps;
  a.run = p.run;
  a.hp = p.hp;
  a.s = p.s;
  a.vec = w % 4 == 0 && (uintptr_t)band % 16 == 0;
  a.thresh = thresh;
  a.loaded = loaded;
  const float* t = (const float*)taps;
  for (int i = 0; i < MAX_TAPS; ++i) a.taps[i] = i < ntaps ? t[i] : 0.0f;
  const dim3 grid((unsigned)p.tiles, (unsigned)p.runs);
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.fixed)
    band_profiles_kernel<3, 13><<<grid, NT, p.smem, st>>>(a);
  else
    band_profiles_kernel<0, 0><<<grid, NT, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Returns 0, a cudaError_t, or BAND_TOO_LARGE (-1), as band_plan.
extern "C" int hsip_band_profiles(const void* band, const void* prior,
                                  void* sobel, void* grad, void* inten,
                                  int n, int b, int w, int k, int ntaps,
                                  const void* taps, float thresh,
                                  void* stream) {
  return band_launch(band, prior, sobel, grad, inten, n, b, w, k, ntaps, taps,
                     thresh, stream, nullptr, false);
}

// hsip_band_profiles for measurement: the kernel adds the bytes of band
// tiles its blocks copy from device memory to `*loaded` (a device
// unsigned long long); `runtime_counts` != 0 runs the runtime-count
// instantiation also for (3, 13).
extern "C" int hsip_band_profiles_probe(const void* band, const void* prior,
                                        void* sobel, void* grad, void* inten,
                                        int n, int b, int w, int k, int ntaps,
                                        const void* taps, float thresh,
                                        void* stream, void* loaded,
                                        int runtime_counts) {
  return band_launch(band, prior, sobel, grad, inten, n, b, w, k, ntaps, taps,
                     thresh, stream, (unsigned long long*)loaded,
                     runtime_counts != 0);
}
