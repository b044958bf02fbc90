// The flame tracker's state machine over V videos of M frames each: one
// block of two warps per video. The tracker warp runs the position chain,
// a loop over the frames with the frames' profile rows streamed into a
// shared-memory ring ahead of use; the bookkeeping warp turns the positions
// it hands over into every output, 32 frames at a time.
//
// Replaces hsip_tpu/track/pallas_scan.py::pallas_tracking_scan_batched
// (kernel body _make_kernel; detectors _pl_threshold, _pl_half_maximum,
// _pl_gradient; helpers _first_col, _row_max). The TPU kernel carried the
// state from one step of a sequential grid to the next; Hopper blocks run
// in no order, so the frame loop lives inside a warp and the state in
// registers, identical in all 32 lanes (each lane updates it from the same
// warp-wide reduction results, so no broadcast is needed).
//
// What bounds it: the chain's latency. Frame j+1's search window depends
// on frame j's position, so the M steps form one serial chain; the time is
// M x (latency of one step). The bytes bound it far less: a step needs only
// its window's columns of the rows, about a tenth of W = 1024 once a front
// is tracked, so at V=1, M=2048 the function reads about 2 MB, under 1 us
// at 3.35 TB/s (chip_smoke.py computes it from each run's windows), against
// about 3 ms for the chain of the previous design.
//
// The previous design (one 256-thread block per video) paid, in every step, a
// round trip to device memory for the step's rows (their loads waited on
// the previous step's window) and two or three block reductions, each a
// shuffle tree, a shared-memory write, a __syncthreads() across 8 warps
// and a serial 8-entry pass; it swept all W columns every step, and ran the
// velocity update and its IEEE divisions inside the chain. About 1.5 us a
// step. This design takes each of those out of the chain:
//
// * Rows arrive ahead of use. Frame loads do not depend on the tracker
//   state, so a ring in dynamic shared memory is filled ahead: two slots,
//   each a group of K consecutive frames (K = 8 at W = 1024: 128 KB for the
//   two line sets of 'combined'). A video's frames are contiguous, so a
//   group is one TMA bulk copy per line set (cp.async.bulk, completing on
//   the slot's mbarrier) when the rows are 16-byte aligned (W % 4 == 0),
//   else 4-byte cp.async copies by all lanes that arrive on the same
//   mbarrier. While the warp works through one group the other is in
//   flight; a step reads only shared memory, and the barrier test and the
//   copy issue are paid once a group. The copies carry whole rows, about
//   ten times the bytes the windows need: free at V=1, where the chain
//   bounds the kernel, but with a video on every SM (V >~ 100, the
//   --library case) 16.8 MB a video each 0.85 ms nears the HBM rate, and a
//   copy of only the columns right of the last position is the next step.
// * One warp per chain: no __syncthreads, no shared scratch, no cross-warp
//   pass. Each reduction is one or two redux.sync instructions (integer
//   min/max across the warp, sm_80+) on order-preserving integer keys of
//   the floats, cheaper than a five-level __shfl_xor_sync tree (and than
//   ballots, measured); the first column below a level is a __ballot_sync
//   scan that stops at the first 32-column chunk holding one.
// * Only the window is swept. Each lane visits c = max(s0,0) + lane, ...
//   < min(s1,W) in steps of 32; out-of-window columns carry the identity of
//   each reduction, so they cannot change a result. The one exception is
//   'threshold', where a column at or past peak_idx outside the window
//   counts as below the level; the first such column has the closed form
//   max(peak_idx, min(s1, W)) when that is < W (every column from min(s1,W)
//   on lies outside the window, and peak_idx lies inside it whenever the
//   peak is real; when no in-window value beats the identity, the result
//   is -1 either way, since peak > min_intensity fails).
// * Only the position is in the chain. The tracker warp hands each step's
//   position to the bookkeeping warp through a shared-memory ring of 1024
//   entries (a counter published once a group). Everything else the plain
//   version carries from step to step (the last active frame, the last two
//   velocities, the entry count, the DDT / exit / velocity-drop latches)
//   is a select a frame, so the bookkeeping warp takes 32 frames at once,
//   one a lane: each lane finds its frame's state by a ballot over the
//   lanes below it and a shuffle from the lane that set it, the velocity
//   divisions run in all lanes together, and it stores every per-frame
//   output coalesced. It keeps well ahead of the chain.
// * The tracker's per-frame scalars (frame index; not empty and with a
//   prior) come 32 frames at a time into registers, loaded one chunk ahead,
//   and each step's are read one step early, off the chain.
//
// * One kernel instance a detector (and ring depth), so the tracker's loop
//   holds one detector's code and no dispatch.
//
// Aim: about 0.2-0.4 us a step, so 0.4-0.8 ms at M=2048. A step is still a
// chain of dependent instructions issued by one warp, among them shared
// loads and four warp-wide reductions whose latency one warp cannot hide,
// so it stays far above the byte bound: about 0.42 us a step for
// 'combined' on an H100 (PERF.md). Blocks of other videos run on other SMs
// (one block per SM at W=1024).
//
// Exactness: each reduction reproduces the plain version's: first index on
// ties (argmin of the gradient, argmax of the peak, first column below the
// level), the rightmost |sobel| above fraction*max as a max over column
// indices, and the gradient detector's lexicographic (hi, lo, col) minimum
// over TwoSum differences. Integer keys order non-NaN floats as the float
// compares do (-0.0 is folded onto +0.0 first, so the two tie). Built with
// -fmad=false, so v1, the fraction*peak products and TwoSum round each
// operation as float32. The kernel never stops early: its stop, DDT and
// clear-vc latches are advisory; tables come from the float64 replay of the
// positions.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define FULL 0xffffffffu
#define NEG_F (-3.0e38f)
#define POS_F (3.0e38f)
#define BIG_I (1 << 30)
#define SMEM_LIMIT 232448  // bytes of shared memory a Hopper block may use

enum { M_COMBINED = 0, M_THRESHOLD = 1, M_HALF_MAXIMUM = 2, M_GRADIENT = 3 };

struct ScanArgs {
  const int* frame_indices;
  const float* prof0;  // sobel ('combined') or intensity (named methods)
  const float* prof1;  // gradient ('combined'), else unused
  const uint8_t* empty;
  const uint8_t* has_prior;
  const float* calibration;
  const float* frame_rate;
  const int* max_disp;
  int* final_pos;
  uint8_t* recorded;
  uint8_t* is_post;
  int* s0_out;
  int* s1_out;
  int* stop_step;
  int* stop_reason;
  int* ddt_frame;
  int* clear_vc;
  int v, m, w;
  int edge_margin, search_window, exit_margin, method;
  float min_grad, sobel_frac, ddt_jump, method_frac;
  int nrows;        // profile rows a frame needs: 2 ('combined') or 1
  int slot_floats;  // ring slot (one group of frames), a multiple of 4 floats
  int bulk;         // 1: TMA bulk copies; 0: 4-byte cp.async copies
};

// ---- order-preserving float keys ----

// Signed-int key with key(a) < key(b) iff a < b for non-NaN floats; -0.0
// and +0.0 get the same key (they compare equal as floats).
__device__ __forceinline__ int fkey(float f) {
  const int i = __float_as_int(f == 0.0f ? 0.0f : f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float funkey(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// ---- shared-memory ring: mbarriers, TMA bulk copies, cp.async ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// One arrival that also expects `bytes` of transactions in this phase.
__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// True once the phase of the given parity has completed.
__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, P1;\n\t"
      "}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase; a copy that never lands traps (a launch error)
// after 2^26 tries instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  for (int tries = 0; !bar_try_wait(bar, parity); ++tries)
    if (tries == (1 << 26)) __trap();
}
// TMA bulk copy global -> shared (16-byte aligned, size a multiple of 16);
// completion counts against the barrier's expected transactions.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
// The barrier's arrival fires once this lane's earlier cp.async copies land
// (.noinc: the barrier's count already includes the 32 lanes).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Start the copy of `n` consecutive frames' rows (from row `row` of the
// (V*M, W) line sets) into a ring slot: prof0's rows at dst, prof1's at
// dst + k*W. The frames of a video are contiguous, so each line set is one
// copy of n*W floats.
__device__ __forceinline__ void issue_group(const ScanArgs& a, size_t row, int n, int k,
                                            float* dst, uint64_t* bar, int lane) {
  const int W = a.w;
  const float* src0 = a.prof0 + row * W;
  const float* src1 = a.nrows == 2 ? a.prof1 + row * W : nullptr;
  const int count = n * W;
  if (a.bulk) {
    if (lane == 0) {
      const unsigned bytes = (unsigned)count * 4u;
      bar_arrive_expect_tx(bar, bytes * (unsigned)a.nrows);
      bulk_g2s(dst, src0, bytes, bar);
      if (src1) bulk_g2s(dst + (size_t)k * W, src1, bytes, bar);
    }
  } else {
    for (int c = lane; c < count; c += WARP) {
      cp_async4(dst + c, src0 + c);
      if (src1) cp_async4(dst + (size_t)k * W + c, src1 + c);
    }
    cp_async_arrive(bar);
  }
}

// ---- detectors (warp-wide; every lane returns the same value) ----

// Knuth TwoSum: s + e == a + b exactly, s = fl(a + b).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bp = s - a;
  e = (a - (s - bp)) + (b - bp);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The window is swept in blocks of BLK columns, U to a lane (c = base +
// u*32 + lane): the U shared loads of a block issue back to back, so a
// block pays one load latency. Columns rise within a lane, so a strict
// compare keeps the first index on ties. The first block is always visited
// (a window that fits it, the common case once a front is tracked, is
// swept with no loop); wider windows visit the rest in a loop.
#define U 4
#define BLK (U * WARP)

// 'combined', one block: the gradient's running first argmin and the
// running max of |sobel|; leaves the block's |sobel| in sabs.
__device__ __forceinline__ void combined_block(const float* sob, const float* grad,
                                               int base, int hi, int lane, float& gm,
                                               int& gc, float& sm, float (&sabs)[U]) {
  float g[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = base + u * WARP + lane;
    g[u] = c < hi ? grad[c] : POS_F;
    sabs[u] = c < hi ? fabsf(sob[c]) : NEG_F;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool better = g[u] < gm;
    gm = better ? g[u] : gm;
    gc = better ? base + u * WARP + lane : gc;
    sm = fmaxf(sm, sabs[u]);
  }
}

// 'combined': max of the gradient argmin (below -min_grad) and the
// rightmost |sobel| above sobel_frac * max|sobel| (max above min_grad).
__device__ __forceinline__ int detect_combined(const float* sob, const float* grad,
                                               int lo, int hi, bool nonempty,
                                               float min_grad, float sobel_frac,
                                               int lane) {
  float gm = POS_F, sm = NEG_F;
  int gc = BIG_I;
  float sabs[U];  // |sobel| of the first block: the whole window when it fits
  combined_block(sob, grad, lo, hi, lane, gm, gc, sm, sabs);
  const bool wide = hi - lo > BLK;
  if (wide) {
    float rest[U];
#pragma unroll 1
    for (int base = lo + BLK; base < hi; base += BLK)
      combined_block(sob, grad, base, hi, lane, gm, gc, sm, rest);
  }
  const int gk = fkey(gm);
  const int gkey = __reduce_min_sync(FULL, gk);
  const int pos_g = __reduce_min_sync(FULL, gk == gkey ? gc : BIG_I);
  const float gmin = funkey(gkey);
  const float smax = funkey(__reduce_max_sync(FULL, fkey(sm)));
  const float thr = smax * sobel_frac;
  int pos_s = -1;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = lo + u * WARP + lane;
    pos_s = (c < hi && sabs[u] > thr) ? c : pos_s;
  }
  if (wide) {
#pragma unroll 1
    for (int base = lo + BLK; base < hi; base += BLK) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * WARP + lane;
        if (c < hi && fabsf(sob[c]) > thr) pos_s = c;
      }
    }
  }
  pos_s = __reduce_max_sync(FULL, pos_s);
  const bool g_ok = nonempty && gmin < -min_grad;
  const bool s_ok = nonempty && smax > min_grad && pos_s >= 0;
  return max(g_ok ? pos_g : -1, s_ok ? pos_s : -1);
}

// One block of a row: the running first argmax.
__device__ __forceinline__ void peak_block(const float* row, int base, int hi, int lane,
                                           float& pm, int& pidx) {
  float x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = base + u * WARP + lane;
    x[u] = c < hi ? row[c] : NEG_F;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool better = x[u] > pm;
    pm = better ? x[u] : pm;
    pidx = better ? base + u * WARP + lane : pidx;
  }
}

// 'threshold' / 'half_maximum': the window peak (first argmax), then the
// first column right of it that falls below fraction * peak.
__device__ __forceinline__ int detect_profile_edge(const float* row, int W, int lo,
                                                   int hi, bool half_max,
                                                   float fraction,
                                                   float min_intensity, int lane) {
  float pm = NEG_F;
  int pidx = BIG_I;
  peak_block(row, lo, hi, lane, pm, pidx);
#pragma unroll 1
  for (int base = lo + BLK; base < hi; base += BLK) peak_block(row, base, hi, lane, pm, pidx);
  const int pk = fkey(pm);
  const int peak_key = __reduce_max_sync(FULL, pk);
  const int peak_idx = __reduce_min_sync(FULL, pk == peak_key ? pidx : BIG_I);
  const float peak = funkey(peak_key);
  const float level = fraction * peak;
  // First in-window column at or past the peak that is below the level.
  int first_below = BIG_I;
  // One ballot per 32-column chunk from shared memory, stopping at the first
  // chunk with a hit (usually the first: the edge lies near the peak).
#pragma unroll 1
  for (int base = max(lo, peak_idx); base < hi; base += WARP) {
    const int c = base + lane;
    bool below = false;
    if (c < hi) below = half_max ? row[c] < level : !(row[c] >= level);
    const unsigned hits = __ballot_sync(FULL, below);
    if (hits) {
      first_below = base + __ffs(hits) - 1;
      break;
    }
  }
  if (!half_max) {
    // Out-of-window columns at or past the peak count as below (closed form).
    const int outside = max(peak_idx, hi);
    if (outside < W) first_below = min(first_below, outside);
  }
  // Largest in-window column, -1 when the window holds no column.
  const int window_end = hi > lo ? hi - 1 : -1;
  const int edge = first_below > window_end ? window_end : first_below - 1;
  const bool ok = (peak > min_intensity) && (edge >= peak_idx);
  return ok ? edge : -1;
}

// 'gradient', one block: the running lexicographic (hi, lo, col) minimum of
// the TwoSum central differences, one-sided at the window's edges.
__device__ __forceinline__ void gradient_block(const float* row, int W, int s0, int s1,
                                               int base, int hi, int lane, float l_hi,
                                               float l_lo, float r_hi, float r_lo,
                                               float& bh, float& bl, int& pos) {
  float right[U], left[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = min(base + u * WARP + lane, hi - 1);
    right[u] = row[min(c + 1, W - 1)];
    left[u] = row[max(c - 1, 0)];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = base + u * WARP + lane;
    float g_hi, g_lo;
    two_sum(right[u], -left[u], g_hi, g_lo);
    // The right edge wins where the window is one column wide.
    g_hi = c == s1 - 1 ? r_hi : (c == s0 ? l_hi : g_hi * 0.5f);  // * 0.5 is exact
    g_lo = c == s1 - 1 ? r_lo : (c == s0 ? l_lo : g_lo * 0.5f);
    const bool better = c < hi && (g_hi < bh || (g_hi == bh && g_lo < bl));
    bh = better ? g_hi : bh;
    bl = better ? g_lo : bl;
    pos = better ? c : pos;
  }
}

// 'gradient': steepest drop of the windowed profile, one-sided at the
// window edges, compared exactly as float64 through TwoSum (hi, lo) pairs.
__device__ __forceinline__ int detect_gradient(const float* row, int W, int s0, int s1,
                                               int lo, int hi, float min_strength,
                                               int lane) {
  float l_hi, l_lo, r_hi, r_lo;
  two_sum(row[clampi(s0 + 1, 0, W - 1)], -row[clampi(s0, 0, W - 1)], l_hi, l_lo);
  two_sum(row[clampi(s1 - 1, 0, W - 1)], -row[clampi(s1 - 2, 0, W - 1)], r_hi, r_lo);
  float bh = POS_F, bl = POS_F;
  int pos = BIG_I;
  if (hi > lo) {
    gradient_block(row, W, s0, s1, lo, hi, lane, l_hi, l_lo, r_hi, r_lo, bh, bl, pos);
#pragma unroll 1
    for (int base = lo + BLK; base < hi; base += BLK)
      gradient_block(row, W, s0, s1, base, hi, lane, l_hi, l_lo, r_hi, r_lo, bh, bl,
                     pos);
  }
  const int hk = fkey(bh), lk = fkey(bl);
  const int h_min = __reduce_min_sync(FULL, hk);
  const int l_min = __reduce_min_sync(FULL, hk == h_min ? lk : 0x7fffffff);
  pos = __reduce_min_sync(FULL, (hk == h_min && lk == l_min) ? pos : BIG_I);
  const float m_hi = funkey(h_min), m_lo = funkey(l_min);
  // float64 (hi + lo) < T, with |lo| <= ulp(hi)/2 and T exactly float32.
  const float t = -min_strength;
  const bool lt_t = m_hi < t || (m_hi == t && m_lo < 0.0f);
  const bool lt_0 = m_hi < 0.0f || (m_hi == 0.0f && m_lo < 0.0f);
  const bool ok = lt_t && lt_0 && (s1 - s0 >= 2);
  return ok ? pos : -1;
}

// Per-frame scalars of one video for the tracker warp, 32 frames to a
// chunk, one lane per frame: `nxt` holds the chunk after the current one,
// so its loads land 32 steps before they are read. Step j reads its frame
// by shuffle, and whether it may detect (not empty, has a prior) from a
// ballot mask.
struct FrameScalars {
  int fi_cur = 0, fi_nxt = 0;
  unsigned ok_cur = 0;
  bool ok_nxt = false;

  __device__ __forceinline__ void load(const ScanArgs& a, size_t vm, int j, int lane) {
    ok_nxt = false;
    if (j + lane < a.m) {
      fi_nxt = a.frame_indices[vm + j + lane];
      ok_nxt = a.empty[vm + j + lane] == 0 && a.has_prior[vm + j + lane] != 0;
    }
  }
  __device__ __forceinline__ void step(const ScanArgs& a, size_t vm, int j, int lane,
                                       int& frame, bool& ok) {
    const int jl = j & (WARP - 1);
    if (jl == 0) {
      fi_cur = fi_nxt;
      ok_cur = __ballot_sync(FULL, ok_nxt);
      load(a, vm, j + WARP, lane);
    }
    frame = __shfl_sync(FULL, fi_cur, jl);
    ok = (ok_cur >> jl) & 1u;
  }
};

// Shared-memory layout: [0, 16) the two ring barriers, [16, 24) the
// hand-off counters, [128, 128 + 4*HANDOFF) the hand-off of positions,
// then the two ring slots.
#define HANDOFF 1024
#define RING_OFFSET (128 + 4 * HANDOFF)

// Spin (sleeping between reads) until *counter > at least; returns it. A
// partner warp that never arrives traps after 2^26 reads.
__device__ __forceinline__ int wait_counter(volatile int* counter, int at_least) {
  int v;
  for (int tries = 0; (v = *counter) <= at_least; ++tries) {
    if (tries == (1 << 26)) __trap();
    __nanosleep(64);
  }
  __threadfence_block();
  return v;
}

// The tracker warp: the position chain. Window from the last detection,
// the detector on the step's rows from the ring, the position handed to the
// bookkeeping warp. Nothing else runs in this loop: every output is written
// by the other warp.
template <int K, int METHOD>
__device__ __forceinline__ void track_positions(const ScanArgs& a, unsigned char* smem,
                                                int lane) {
  uint64_t* bars = (uint64_t*)smem;
  volatile int* produced = (volatile int*)(smem + 16);
  volatile int* consumed = (volatile int*)(smem + 20);
  volatile int* handoff = (volatile int*)(smem + 128);
  float* ring = (float*)(smem + RING_OFFSET);
  const int vid = blockIdx.x;
  const int W = a.w, M = a.m;
  const size_t vm = (size_t)vid * M;
  const int md = a.max_disp[vid];
  const int edge = a.edge_margin, right_edge = W - a.edge_margin, sw = a.search_window;
  const float min_grad = a.min_grad, sobel_frac = a.sobel_frac, method_frac = a.method_frac;

  for (int g = 0; g < 2 && g * K < M; ++g)
    issue_group(a, vm + (size_t)g * K, min(K, M - g * K), K,
                ring + (size_t)g * a.slot_floats, &bars[g], lane);
  FrameScalars fs;
  fs.load(a, vm, 0, lane);
  int frame;
  bool ok;
  fs.step(a, vm, 0, lane, frame, ok);

  int lv_pos = -1, lv_frame = 0;
  int seen_consumed = 0;

  for (int j = 0; j < M; ++j) {
    // ---- search bounds (velocity-constrained, monotone rightward) ----
    const bool no_hist = lv_pos < 0;
    const int elapsed = max(1, frame - lv_frame);
    const int s0 = no_hist ? edge : lv_pos;
    // int32 wrap-around as in the plain version (unsigned cannot overflow).
    const int reach =
        (int)((unsigned)lv_pos + (unsigned)md * (unsigned)elapsed + (unsigned)sw);
    const int s1 = no_hist ? right_edge : min(right_edge, reach);
    const bool window_nonempty = s1 > s0;
    const int lo = max(s0, 0), hi = min(s1, W);

    // The next step's scalars, fetched here so their shuffles are off the
    // chain.
    int next_frame = 0;
    bool next_ok = false;
    if (j + 1 < M) fs.step(a, vm, j + 1, lane, next_frame, next_ok);

    // ---- candidate, from the ring: group g = j / K in slot g % 2 ----
    const int g = j / K, jk = j % K;
    float* slot = ring + (size_t)(g & 1) * a.slot_floats;
    if (jk == 0) {
      bar_wait(&bars[g & 1], (unsigned)(g >> 1) & 1u);
      // Room in the hand-off for this group (the other warp runs ahead of
      // it in practice, so this is one shared read).
      if (j + K - seen_consumed > HANDOFF)
        seen_consumed = wait_counter(consumed, j + K - HANDOFF - 1);
    }
    const float* row0 = slot + (size_t)jk * W;
    int final_pos;
    if (METHOD == M_COMBINED) {
      final_pos = detect_combined(row0, row0 + (size_t)K * W, lo, hi, window_nonempty,
                                  min_grad, sobel_frac, lane);
    } else if (METHOD == M_GRADIENT) {
      final_pos = detect_gradient(row0, W, s0, s1, lo, hi, min_grad, lane);
    } else {
      final_pos = detect_profile_edge(row0, W, lo, hi, METHOD == M_HALF_MAXIMUM,
                                      method_frac, min_grad, lane);
    }
    if (!window_nonempty || !ok) final_pos = -1;
    if (final_pos >= 0) {
      lv_pos = final_pos;
      lv_frame = frame;
    }

    if (lane == 0) handoff[j & (HANDOFF - 1)] = final_pos;
    if (jk == K - 1 || j == M - 1) {
      // The group's last frame: publish its positions, and (every lane
      // being done with the slot) refill the slot with group g + 2.
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *produced = j + 1;
      }
      if ((g + 2) * K < M)
        issue_group(a, vm + (size_t)(g + 2) * K, min(K, M - (g + 2) * K), K, slot,
                    &bars[g & 1], lane);
    }
    frame = next_frame;
    ok = next_ok;
  }
}

// Highest set lane of a ballot mask, -1 for none.
__device__ __forceinline__ int last_lane(unsigned m) { return 31 - __clz(m); }

// The bookkeeping warp: everything but the position chain, 32 frames at a
// time, one lane per frame, from the positions the tracker warp hands over.
// The state it carries from chunk to chunk is a handful of selects a frame
// (the last detection, the last active frame, the last two velocities, the
// entry count, the latches), so within a chunk each lane finds its frame's
// state by ballots over the lanes below it and shuffles from the lane that
// set it; the IEEE divisions of the velocities run in all lanes at once.
// Outputs: every per-frame field (final_pos, s0, s1, recorded, is_post) and
// the per-video latches; they mirror the plain version's step.
__device__ __forceinline__ void track_bookkeeping(const ScanArgs& a, unsigned char* smem,
                                                  int lane) {
  volatile int* produced = (volatile int*)(smem + 16);
  volatile int* consumed = (volatile int*)(smem + 20);
  volatile int* handoff = (volatile int*)(smem + 128);
  const int vid = blockIdx.x;
  const int W = a.w, M = a.m;
  const size_t vm = (size_t)vid * M;
  const float cal = a.calibration[vid];
  const float fr = a.frame_rate[vid];
  const int md = a.max_disp[vid];
  const unsigned below = (1u << lane) - 1u;  // lanes < this one
  const unsigned upto = below | (1u << lane);

  // Carried state (as the plain version names it) after the last chunk.
  int lv_pos = -1, lv_frame = 0, p1_frame = 0, p1_pos = -1;
  float v_latest = 0.0f, v_prev = 0.0f;
  int n_entries = 0, ddt = -1;
  bool stopped = false;
  int stop_step = -1, stop_reason = 0, clear_vc = -1;
  int avail = 0;

  int fi_nxt = 0;
  bool em_nxt = true;
  if (lane < M) {
    fi_nxt = a.frame_indices[vm + lane];
    em_nxt = a.empty[vm + lane] != 0;
  }
  for (int base = 0; base < M; base += WARP) {
    const int n = min(WARP, M - base);
    const bool valid = lane < n;
    const int frame = fi_nxt;
    const bool active = valid && !em_nxt;
    if (base + WARP + lane < M) {
      fi_nxt = a.frame_indices[vm + base + WARP + lane];
      em_nxt = a.empty[vm + base + WARP + lane] != 0;
    }
    if (avail < base + n) avail = wait_counter(produced, base + n - 1);
    const int fp = valid ? handoff[(base + lane) & (HANDOFF - 1)] : -1;
    __syncwarp();
    if (lane == 0) *consumed = base + n;
    const bool detected = fp >= 0;  // the tracker sends -1 for inactive frames

    // ---- search bounds: the last detection before this frame ----
    const unsigned det_mask = __ballot_sync(FULL, detected);
    const int ld = last_lane(det_mask & below);
    const int ld_pos = __shfl_sync(FULL, fp, max(ld, 0));
    const int ld_frame = __shfl_sync(FULL, frame, max(ld, 0));
    const int h_pos = ld >= 0 ? ld_pos : lv_pos;
    const int h_frame = ld >= 0 ? ld_frame : lv_frame;
    const bool no_hist = h_pos < 0;
    const int elapsed = max(1, frame - h_frame);
    const int s0 = no_hist ? a.edge_margin : h_pos;
    const int reach = (int)((unsigned)h_pos + (unsigned)md * (unsigned)elapsed +
                            (unsigned)a.search_window);
    const int s1 = no_hist ? W - a.edge_margin : min(W - a.edge_margin, reach);

    // ---- velocities (mirror FlameTracker._update_velocities) ----
    const int la = last_lane(__ballot_sync(FULL, active) & below);
    const int la_frame = __shfl_sync(FULL, frame, max(la, 0));
    const int la_pos = __shfl_sync(FULL, fp, max(la, 0));
    const int q_frame = la >= 0 ? la_frame : p1_frame;
    const int q_pos = la >= 0 ? la_pos : p1_pos;
    bool vel_ok = false;
    float v1 = 0.0f;
    if (detected && q_pos >= 0 && fr > 0.0f) {
      const float dt = (float)(frame - q_frame) / fr;
      vel_ok = dt > 0.0f;
      if (vel_ok) v1 = ((float)(fp - q_pos) * cal) / dt;
    }
    const unsigned vel_mask = __ballot_sync(FULL, vel_ok);
    const int nn = n_entries + __popc(vel_mask & upto);
    const int n_before = n_entries + __popc(vel_mask & below);
    // The last two velocities up to this frame, and the last before it.
    const int l1 = last_lane(vel_mask & upto);
    const int l2 = last_lane(vel_mask & upto & ~(1u << max(l1, 0)));
    const int lb = last_lane(vel_mask & below);
    const float v_l1 = __shfl_sync(FULL, v1, max(l1, 0));
    const float v_l2 = __shfl_sync(FULL, v1, max(l2, 0));
    const float v_lb = __shfl_sync(FULL, v1, max(lb, 0));
    const float nv_latest = l1 >= 0 ? v_l1 : v_latest;
    const float nv_prev = l2 >= 0 ? v_l2 : (l1 >= 0 ? v_latest : v_prev);
    const float v_before = lb >= 0 ? v_lb : v_latest;

    // ---- DDT latch (first v1 jump above threshold) ----
    const bool ddt_cand = vel_ok && n_before >= 1 && (v1 - v_before > a.ddt_jump);
    const unsigned ddt_mask = __ballot_sync(FULL, ddt_cand);
    const int first_ddt = __ffs(ddt_mask) - 1;
    const int ddt_at = __shfl_sync(FULL, frame, max(first_ddt, 0));
    const int nddt = ddt >= 0 ? ddt : ((ddt_mask & upto) ? ddt_at : -1);

    // ---- exit / velocity-drop (advisory latches) ----
    const bool exit_hit = detected && fp >= W - a.exit_margin;
    bool vdrop_hit = false;
    if (active && !exit_hit && nn >= 2 && nv_prev > 100.0f)
      vdrop_hit = (nv_prev - nv_latest) / nv_prev > 0.5f;
    const bool stopped_now = exit_hit || vdrop_hit;
    const unsigned stop_mask = __ballot_sync(FULL, stopped_now);
    if (!stopped && stop_mask) {
      const int first = __ffs(stop_mask) - 1;
      const int reason = __shfl_sync(FULL, exit_hit ? 1 : 2, first);
      const int nn_at = __shfl_sync(FULL, nn, first);
      stop_step = base + first;
      stop_reason = reason;
      if (nn_at >= 2) clear_vc = nn_at - 2;
      stopped = true;
    }

    if (valid) {
      const size_t o = vm + base + lane;
      a.final_pos[o] = fp;
      a.s0_out[o] = s0;
      a.s1_out[o] = s1;
      a.recorded[o] = (uint8_t)(detected && !stopped_now);
      a.is_post[o] = (uint8_t)(nddt >= 0 && frame >= nddt);
    }

    // ---- carry the state of the chunk's last frame ----
    const int last = n - 1;
    lv_pos = __shfl_sync(FULL, detected ? fp : h_pos, last);
    lv_frame = __shfl_sync(FULL, detected ? frame : h_frame, last);
    p1_frame = __shfl_sync(FULL, active ? frame : q_frame, last);
    p1_pos = __shfl_sync(FULL, active ? fp : q_pos, last);
    v_latest = __shfl_sync(FULL, nv_latest, last);
    v_prev = __shfl_sync(FULL, nv_prev, last);
    n_entries = __shfl_sync(FULL, nn, last);
    ddt = __shfl_sync(FULL, nddt, last);
  }
  if (lane == 0) {
    a.stop_step[vid] = stop_step;
    a.stop_reason[vid] = stop_reason;
    a.ddt_frame[vid] = ddt;
    a.clear_vc[vid] = clear_vc;
  }
}

// One block of two warps per video; K frames to a ring group, two groups;
// one instance a detector, so the tracker's loop holds only its code.
template <int K, int METHOD>
__global__ void __launch_bounds__(2 * WARP) tracking_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & (WARP - 1);
  if (threadIdx.x == 0) {
    uint64_t* bars = (uint64_t*)smem;
    for (int s = 0; s < 2; ++s) bar_init(&bars[s], a.bulk ? 1u : (unsigned)WARP);
    *(volatile int*)(smem + 16) = 0;  // produced
    *(volatile int*)(smem + 20) = 0;  // consumed
  }
  bar_init_fence();
  __syncthreads();
  if (threadIdx.x < WARP)
    track_positions<K, METHOD>(a, smem, lane);
  else
    track_bookkeeping(a, smem, lane);
}

template <int K, int METHOD>
static int launch_method(const ScanArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tracking_scan_kernel<K, METHOD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  tracking_scan_kernel<K, METHOD><<<a.v, 2 * WARP, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
static int launch(ScanArgs a, cudaStream_t stream) {
  a.slot_floats = (K * a.nrows * a.w + 3) & ~3;
  const size_t smem = RING_OFFSET + 2 * (size_t)a.slot_floats * sizeof(float);
  switch (a.method) {
    case M_COMBINED: return launch_method<K, M_COMBINED>(a, smem, stream);
    case M_THRESHOLD: return launch_method<K, M_THRESHOLD>(a, smem, stream);
    case M_HALF_MAXIMUM: return launch_method<K, M_HALF_MAXIMUM>(a, smem, stream);
    default: return launch_method<K, M_GRADIENT>(a, smem, stream);
  }
}

// Frames in one of the ring's two groups for `method` at row width `w`: the
// largest of 8, 4, 2, 1 whose two slots fit a block's shared memory; 0 when
// two frames' rows do not fit (the launcher refuses such a width).
extern "C" int hsip_tracking_scan_ring_depth(int method, int w) {
  if (w <= 0) return 0;
  const size_t nrows = method == M_COMBINED ? 2 : 1;
  for (int k = 8; k >= 1; k /= 2) {
    const size_t slot = ((k * nrows * (size_t)w + 3) & ~(size_t)3) * sizeof(float);
    if (RING_OFFSET + 2 * slot <= SMEM_LIMIT) return k;
  }
  return 0;
}

extern "C" int hsip_tracking_scan(
    const void* frame_indices, const void* prof0, const void* prof1,
    const void* empty, const void* has_prior, const void* calibration,
    const void* frame_rate, const void* max_disp, void* final_pos,
    void* recorded, void* is_post, void* s0, void* s1, void* stop_step,
    void* stop_reason, void* ddt_frame, void* clear_vc, int v, int m, int w,
    int edge_margin, int search_window, int exit_margin, int method,
    float min_grad, float sobel_frac, float ddt_jump, float method_frac,
    void* stream) {
  if (v <= 0 || m <= 0 || w <= 0 || method < M_COMBINED || method > M_GRADIENT ||
      (method == M_COMBINED && prof1 == nullptr))
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.frame_indices = (const int*)frame_indices;
  a.prof0 = (const float*)prof0;
  a.prof1 = (const float*)prof1;
  a.empty = (const uint8_t*)empty;
  a.has_prior = (const uint8_t*)has_prior;
  a.calibration = (const float*)calibration;
  a.frame_rate = (const float*)frame_rate;
  a.max_disp = (const int*)max_disp;
  a.final_pos = (int*)final_pos;
  a.recorded = (uint8_t*)recorded;
  a.is_post = (uint8_t*)is_post;
  a.s0_out = (int*)s0;
  a.s1_out = (int*)s1;
  a.stop_step = (int*)stop_step;
  a.stop_reason = (int*)stop_reason;
  a.ddt_frame = (int*)ddt_frame;
  a.clear_vc = (int*)clear_vc;
  a.v = v;
  a.m = m;
  a.w = w;
  a.edge_margin = edge_margin;
  a.search_window = search_window;
  a.exit_margin = exit_margin;
  a.method = method;
  a.min_grad = min_grad;
  a.sobel_frac = sobel_frac;
  a.ddt_jump = ddt_jump;
  a.method_frac = method_frac;
  a.nrows = method == M_COMBINED ? 2 : 1;
  const bool aligned = ((uintptr_t)prof0 & 15) == 0 &&
                       (a.nrows == 1 || ((uintptr_t)prof1 & 15) == 0);
  a.bulk = (w % 4 == 0 && aligned) ? 1 : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hsip_tracking_scan_ring_depth(method, w)) {
    case 8: return launch<8>(a, st);
    case 4: return launch<4>(a, st);
    case 2: return launch<2>(a, st);
    case 1: return launch<1>(a, st);
    default: return (int)cudaErrorInvalidValue;  // two frames' rows exceed it
  }
}

