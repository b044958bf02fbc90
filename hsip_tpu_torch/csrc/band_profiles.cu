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
// What bounds it on Hopper: bytes. Each frame reads its own band and its
// prior's (2 * B * W * 4 bytes) and writes 3 * W * 4; the arithmetic per
// loaded value is a few dozen flops, far below the card's flop/byte
// balance. The TPU kernel held a whole (B, W) band in VMEM; a Hopper block
// has at most 227 KB of shared memory, and at sigma=3, W=1024 two whole
// 31-row band buffers would need 254 KB. So a block takes one frame and
// one tile of TILE output columns, loads the tile plus a halo of
// (k-1) + r_gauss + 1 columns a side from both bands into shared memory,
// and runs every stage there between barriers, ping-ponging two buffers.
// Shared memory grows with B and TILE, never with W. Every stage computes
// the columns the later stages still need, clipped to the image; a read
// past the image edge reflects (scipy 'reflect') onto a column the
// previous stage computed, so each stage pads its own output, as the jnp
// chain's per-stage jnp.pad(mode='symmetric') does.
//
// Exactness: built with -fmad=false, and every sum keeps the jnp tap
// order (out = out + t_j * x_j, left to right; (b0 + 2*b1) + b2), so the
// result rounds as the plain PyTorch chain does.

#include <cuda_runtime.h>

#define TILE 128
#define BLOCK 256
#define MAX_TAPS 129

struct BandArgs {
  const float* band;
  const int* prior;
  float* sobel;
  float* grad;
  float* inten;
  int n, b, w, k, ntaps;
  float thresh;
  float taps[MAX_TAPS];
};

// scipy 'reflect' (numpy 'symmetric'): triangle wave of period 2w.
__device__ __forceinline__ int reflect_col(int c, int w) {
  const int p = 2 * w;
  c %= p;
  if (c < 0) c += p;
  return c >= w ? p - 1 - c : c;
}

__global__ void __launch_bounds__(BLOCK)
band_profiles_kernel(const BandArgs a) {
  extern __shared__ float smem[];
  const int W = a.w, B = a.b, k = a.k;
  const int R = (a.ntaps - 1) / 2;
  const int H = (k - 1) + R + 1;  // halo columns a side
  const int E = TILE + 2 * H;     // row stride of a buffer
  float* X = smem;
  float* Y = smem + B * E;

  const int n = blockIdx.x;
  const int c0 = blockIdx.y * TILE;
  const int base = c0 - H;  // image column of buffer index 0
  int pn = a.prior[n];
  pn = pn < 0 ? 0 : (pn >= a.n ? a.n - 1 : pn);
  const float* cur = a.band + (size_t)n * B * W;
  const float* pri = a.band + (size_t)pn * B * W;

  // Erosion and dilation window offsets (scipy centers an even window
  // left for erosion and right for dilation).
  const int le_e = k / 2, re_e = k - 1 - le_e;
  const int le_d = k - 1 - k / 2, re_d = k / 2;
  const int tid = threadIdx.x;

  // ---- stage 0: diff + threshold, B rows, columns [c0-H, c0+TILE+H) ----
  {
    const int lo = max(0, c0 - H), hi = min(W, c0 + TILE + H);
    const int span = hi - lo;
    for (int i = tid; i < B * span; i += BLOCK) {
      const int r = i / span, c = lo + i % span;
      float d = cur[r * W + c] - pri[r * W + c];
      if (d < a.thresh) d = 0.0f;
      X[r * E + (c - base)] = d;
    }
  }
  __syncthreads();

  // ---- stage 1: erosion along W (X -> Y), B rows ----
  const int lo1 = max(0, c0 - (1 + R + le_d)), hi1 = min(W, c0 + TILE + 1 + R + re_d);
  {
    const int span = hi1 - lo1;
    for (int i = tid; i < B * span; i += BLOCK) {
      const int r = i / span, c = lo1 + i % span;
      const float* xr = X + r * E;
      float v = xr[reflect_col(c - le_e, W) - base];
      for (int off = 1 - le_e; off <= re_e; ++off)
        v = fminf(v, xr[reflect_col(c + off, W) - base]);
      Y[r * E + (c - base)] = v;
    }
  }
  __syncthreads();

  // ---- stage 2: erosion along rows, VALID (Y -> X), B1 rows ----
  const int B1 = B - k + 1;
  {
    const int span = hi1 - lo1;
    for (int i = tid; i < B1 * span; i += BLOCK) {
      const int r = i / span, c = lo1 + i % span;
      const int e = c - base;
      float v = Y[r * E + e];
      for (int o = 1; o < k; ++o) v = fminf(v, Y[(r + o) * E + e]);
      X[r * E + e] = v;
    }
  }
  __syncthreads();

  // ---- stage 3: dilation along W (X -> Y), B1 rows ----
  const int lo3 = max(0, c0 - (1 + R)), hi3 = min(W, c0 + TILE + 1 + R);
  {
    const int span = hi3 - lo3;
    for (int i = tid; i < B1 * span; i += BLOCK) {
      const int r = i / span, c = lo3 + i % span;
      const float* xr = X + r * E;
      float v = xr[reflect_col(c - le_d, W) - base];
      for (int off = 1 - le_d; off <= re_d; ++off)
        v = fmaxf(v, xr[reflect_col(c + off, W) - base]);
      Y[r * E + (c - base)] = v;
    }
  }
  __syncthreads();

  // ---- stage 4: dilation along rows, VALID (Y -> X), B2 rows ----
  const int B2 = B1 - k + 1;
  {
    const int span = hi3 - lo3;
    for (int i = tid; i < B2 * span; i += BLOCK) {
      const int r = i / span, c = lo3 + i % span;
      const int e = c - base;
      float v = Y[r * E + e];
      for (int o = 1; o < k; ++o) v = fmaxf(v, Y[(r + o) * E + e]);
      X[r * E + e] = v;
    }
  }
  __syncthreads();

  // ---- stage 5: Gaussian along W (X -> Y), B2 rows ----
  const int lo5 = max(0, c0 - 1), hi5 = min(W, c0 + TILE + 1);
  {
    const int span = hi5 - lo5;
    for (int i = tid; i < B2 * span; i += BLOCK) {
      const int r = i / span, c = lo5 + i % span;
      const float* xr = X + r * E;
      float v = a.taps[0] * xr[reflect_col(c - R, W) - base];
      for (int j = 1; j < a.ntaps; ++j)
        v = v + a.taps[j] * xr[reflect_col(c - R + j, W) - base];
      Y[r * E + (c - base)] = v;
    }
  }
  __syncthreads();

  // ---- stage 6: Gaussian along rows, VALID (Y -> X), 3 rows ----
  {
    const int span = hi5 - lo5;
    for (int i = tid; i < 3 * span; i += BLOCK) {
      const int r = i / span, c = lo5 + i % span;
      const int e = c - base;
      float v = a.taps[0] * Y[r * E + e];
      for (int j = 1; j < a.ntaps; ++j) v = v + a.taps[j] * Y[(r + j) * E + e];
      X[r * E + e] = v;
    }
  }
  __syncthreads();

  // ---- outputs: Sobel onto the center row, np.gradient, intensity ----
  const float* b0 = X;
  const float* b1 = X + E;
  const float* b2 = X + 2 * E;
  const int hi = min(W, c0 + TILE);
  for (int c = c0 + tid; c < hi; c += BLOCK) {
    const int ep = reflect_col(c + 1, W) - base;
    const int em = reflect_col(c - 1, W) - base;
    const float sp = (b0[ep] + 2.0f * b1[ep]) + b2[ep];
    const float sm = (b0[em] + 2.0f * b1[em]) + b2[em];
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
    a.sobel[o] = sp - sm;
    a.grad[o] = g;
    a.inten[o] = b1[e];
  }
}

extern "C" int hsip_band_profiles(const void* band, const void* prior,
                                  void* sobel, void* grad, void* inten,
                                  int n, int b, int w, int k, int ntaps,
                                  const void* taps, float thresh,
                                  void* stream) {
  if (n <= 0 || w < 2 || k < 1 || ntaps < 1 || ntaps > MAX_TAPS ||
      ntaps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const int r = (ntaps - 1) / 2;
  const int h = (k - 1) + r + 1;
  if (b != 2 * h + 1 || h > TILE) return (int)cudaErrorInvalidValue;
  BandArgs a;
  a.band = (const float*)band;
  a.prior = (const int*)prior;
  a.sobel = (float*)sobel;
  a.grad = (float*)grad;
  a.inten = (float*)inten;
  a.n = n;
  a.b = b;
  a.w = w;
  a.k = k;
  a.ntaps = ntaps;
  a.thresh = thresh;
  const float* t = (const float*)taps;
  for (int i = 0; i < MAX_TAPS; ++i) a.taps[i] = i < ntaps ? t[i] : 0.0f;
  const size_t smem = 2 * (size_t)b * (TILE + 2 * h) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      band_profiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n, (unsigned)((w + TILE - 1) / TILE));
  band_profiles_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
