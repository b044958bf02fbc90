// The flame tracker's state machine over V videos of M frames each: one
// block per video, a loop over the frames inside the block.
//
// Replaces hsip_tpu/track/pallas_scan.py::pallas_tracking_scan_batched
// (kernel body _make_kernel; detectors _pl_threshold, _pl_half_maximum,
// _pl_gradient; helpers _first_col, _row_max). The TPU kernel carried the
// state from one step of a sequential grid to the next; Hopper blocks run
// in no order, so the frame loop lives inside the block and the state in
// registers (every thread holds the same copy and updates it from the same
// block-wide reduction results, so no broadcast is needed).
//
// What bounds it on Hopper: latency, not bytes or flops. Frame j+1's
// search window depends on frame j's position, so the M steps form one
// serial chain; each step reads one or two W-float rows (8 KB at W=1024)
// and runs two or three block reductions. The design keeps each step to
// coalesced row loads (the W columns spread over the threads), warp
// shuffles, and one barrier per block reduction (two alternating shared
// buffers make a second barrier unnecessary). The V videos fill V SMs.
//
// Exactness: each reduction reproduces the jnp one, first index on ties
// (argmin of the gradient, argmax of the peak, first column below the
// threshold), the rightmost |sobel| above fraction*max as a max over
// column indices, and the gradient detector's lexicographic (hi, lo)
// minimum over TwoSum differences. Built with -fmad=false, so v1, the
// fraction*peak products and TwoSum round each operation as float32.
// The kernel never stops early: its stop, DDT and clear-vc latches are
// advisory; tables come from the float64 replay of the positions.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256
#define NWARPS (BLOCK / 32)
#define NEG_F (-3.0e38f)
#define POS_F (3.0e38f)
#define BIG_I (1 << 30)

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
};

// Shared scratch for block reductions: two buffers used alternately, so a
// reduction's buffer is never rewritten before every thread has read it.
struct Scratch {
  float f0[2][NWARPS];
  float f1[2][NWARPS];
  int i0[2][NWARPS];
  int i1[2][NWARPS];
};

// (value, col) lexicographic: smaller value, then smaller col.
__device__ __forceinline__ bool lt_vc(float a, int ac, float b, int bc) {
  return a < b || (a == b && ac < bc);
}
// (value, col): larger value, then smaller col.
__device__ __forceinline__ bool gt_vc(float a, int ac, float b, int bc) {
  return a > b || (a == b && ac < bc);
}
// (hi, lo, col) lexicographic: smaller hi, then smaller lo, then col.
__device__ __forceinline__ bool lt_hlc(float ah, float al, int ac, float bh,
                                       float bl, int bc) {
  return ah < bh || (ah == bh && (al < bl || (al == bl && ac < bc)));
}

struct Reducer {
  Scratch* s;
  int par;
  int lane, warp;

  // min over (value, col) pairs; every thread gets the result.
  __device__ void argmin(float& v, int& c) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oc = __shfl_xor_sync(0xffffffffu, c, o);
      if (lt_vc(ov, oc, v, c)) { v = ov; c = oc; }
    }
    if (lane == 0) { s->f0[par][warp] = v; s->i0[par][warp] = c; }
    __syncthreads();
    v = s->f0[par][0];
    c = s->i0[par][0];
    for (int i = 1; i < NWARPS; ++i)
      if (lt_vc(s->f0[par][i], s->i0[par][i], v, c)) {
        v = s->f0[par][i];
        c = s->i0[par][i];
      }
    par ^= 1;
  }

  // max over values, first col on ties.
  __device__ void argmax(float& v, int& c) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oc = __shfl_xor_sync(0xffffffffu, c, o);
      if (gt_vc(ov, oc, v, c)) { v = ov; c = oc; }
    }
    if (lane == 0) { s->f0[par][warp] = v; s->i0[par][warp] = c; }
    __syncthreads();
    v = s->f0[par][0];
    c = s->i0[par][0];
    for (int i = 1; i < NWARPS; ++i)
      if (gt_vc(s->f0[par][i], s->i0[par][i], v, c)) {
        v = s->f0[par][i];
        c = s->i0[par][i];
      }
    par ^= 1;
  }

  // (value, col) argmin and a float max in one pass.
  __device__ void argmin_and_max(float& v, int& c, float& mx) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oc = __shfl_xor_sync(0xffffffffu, c, o);
      const float om = __shfl_xor_sync(0xffffffffu, mx, o);
      if (lt_vc(ov, oc, v, c)) { v = ov; c = oc; }
      mx = fmaxf(mx, om);
    }
    if (lane == 0) {
      s->f0[par][warp] = v;
      s->i0[par][warp] = c;
      s->f1[par][warp] = mx;
    }
    __syncthreads();
    v = s->f0[par][0];
    c = s->i0[par][0];
    mx = s->f1[par][0];
    for (int i = 1; i < NWARPS; ++i) {
      if (lt_vc(s->f0[par][i], s->i0[par][i], v, c)) {
        v = s->f0[par][i];
        c = s->i0[par][i];
      }
      mx = fmaxf(mx, s->f1[par][i]);
    }
    par ^= 1;
  }

  // (hi, lo, col) lexicographic min.
  __device__ void argmin_hlc(float& h, float& l, int& c) {
    for (int o = 16; o > 0; o >>= 1) {
      const float oh = __shfl_xor_sync(0xffffffffu, h, o);
      const float ol = __shfl_xor_sync(0xffffffffu, l, o);
      const int oc = __shfl_xor_sync(0xffffffffu, c, o);
      if (lt_hlc(oh, ol, oc, h, l, c)) { h = oh; l = ol; c = oc; }
    }
    if (lane == 0) {
      s->f0[par][warp] = h;
      s->f1[par][warp] = l;
      s->i0[par][warp] = c;
    }
    __syncthreads();
    h = s->f0[par][0];
    l = s->f1[par][0];
    c = s->i0[par][0];
    for (int i = 1; i < NWARPS; ++i)
      if (lt_hlc(s->f0[par][i], s->f1[par][i], s->i0[par][i], h, l, c)) {
        h = s->f0[par][i];
        l = s->f1[par][i];
        c = s->i0[par][i];
      }
    par ^= 1;
  }

  __device__ int min_int(int x) {
    for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) s->i1[par][warp] = x;
    __syncthreads();
    x = s->i1[par][0];
    for (int i = 1; i < NWARPS; ++i) x = min(x, s->i1[par][i]);
    par ^= 1;
    return x;
  }

  __device__ int max_int(int x) {
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) s->i1[par][warp] = x;
    __syncthreads();
    x = s->i1[par][0];
    for (int i = 1; i < NWARPS; ++i) x = max(x, s->i1[par][i]);
    par ^= 1;
    return x;
  }
};

// Knuth TwoSum: s + e == a + b exactly, s = fl(a + b).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bp = s - a;
  e = (a - (s - bp)) + (b - bp);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 'threshold' / 'half_maximum': the window peak (first argmax), then the
// first column right of it that falls below fraction * peak.
__device__ int detect_profile_edge(const float* row, int W, int s0, int s1,
                                   bool half_max, float fraction,
                                   float min_intensity, Reducer& red) {
  const int tid = threadIdx.x;
  float peak = NEG_F;
  int peak_idx = BIG_I;
  for (int c = tid; c < W; c += BLOCK) {
    const bool inw = c >= s0 && c < s1;
    const float mv = inw ? row[c] : NEG_F;
    if (gt_vc(mv, c, peak, peak_idx)) { peak = mv; peak_idx = c; }
  }
  red.argmax(peak, peak_idx);
  const float level = fraction * peak;
  int first_below = BIG_I;
  for (int c = tid; c < W; c += BLOCK) {
    const bool inw = c >= s0 && c < s1;
    bool below;
    if (half_max) {
      below = inw && c >= peak_idx && row[c] < level;
    } else {
      below = c >= peak_idx && !(inw && row[c] >= level);
    }
    if (below) { first_below = c; break; }
  }
  first_below = red.min_int(first_below);
  // Largest in-window column, -1 when the window holds no column.
  const int lo = max(s0, 0), hi = min(s1, W) - 1;
  const int window_end = hi >= lo ? hi : -1;
  const int edge = first_below > window_end ? window_end : first_below - 1;
  const bool ok = (peak > min_intensity) && (edge >= peak_idx);
  return ok ? edge : -1;
}

// 'gradient': steepest drop of the windowed profile, one-sided at the
// window edges, compared exactly as float64 through TwoSum (hi, lo) pairs.
__device__ int detect_gradient(const float* row, int W, int s0, int s1,
                               float min_strength, Reducer& red) {
  const int tid = threadIdx.x;
  float l_hi, l_lo, r_hi, r_lo;
  two_sum(row[clampi(s0 + 1, 0, W - 1)], -row[clampi(s0, 0, W - 1)], l_hi, l_lo);
  two_sum(row[clampi(s1 - 1, 0, W - 1)], -row[clampi(s1 - 2, 0, W - 1)], r_hi, r_lo);
  float m_hi = POS_F, m_lo = POS_F;
  int pos = BIG_I;
  for (int c = tid; c < W; c += BLOCK) {
    float g_hi, g_lo;
    two_sum(row[min(c + 1, W - 1)], -row[max(c - 1, 0)], g_hi, g_lo);
    g_hi = g_hi * 0.5f;  // exact
    g_lo = g_lo * 0.5f;
    if (c == s0) { g_hi = l_hi; g_lo = l_lo; }
    if (c == s1 - 1) { g_hi = r_hi; g_lo = r_lo; }
    if (!(c >= s0 && c < s1)) { g_hi = POS_F; g_lo = POS_F; }
    if (lt_hlc(g_hi, g_lo, c, m_hi, m_lo, pos)) { m_hi = g_hi; m_lo = g_lo; pos = c; }
  }
  red.argmin_hlc(m_hi, m_lo, pos);
  // float64 (hi + lo) < T, with |lo| <= ulp(hi)/2 and T exactly float32.
  const float t = -min_strength;
  const bool lt_t = m_hi < t || (m_hi == t && m_lo < 0.0f);
  const bool lt_0 = m_hi < 0.0f || (m_hi == 0.0f && m_lo < 0.0f);
  const bool ok = lt_t && lt_0 && (s1 - s0 >= 2);
  return ok ? pos : -1;
}

__global__ void __launch_bounds__(BLOCK) tracking_scan_kernel(const ScanArgs a) {
  __shared__ Scratch scratch;
  Reducer red;
  red.s = &scratch;
  red.par = 0;
  red.lane = threadIdx.x & 31;
  red.warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;
  const int vid = blockIdx.x;
  const int W = a.w, M = a.m;
  const float cal = a.calibration[vid];
  const float fr = a.frame_rate[vid];
  const int md = a.max_disp[vid];
  const size_t vm = (size_t)vid * M;
  const float* prof0 = a.prof0 + vm * W;
  const float* prof1 = a.prof1 ? a.prof1 + vm * W : nullptr;

  int lv_pos = -1, lv_frame = 0, p1_frame = 0, p1_pos = -1;
  float v_latest = 0.0f, v_prev = 0.0f;
  bool vl_ok = false, vp_ok = false, stopped = false;
  int n_entries = 0, ddt = -1, stop_step = -1, stop_reason = 0, clear_vc = -1;

  for (int j = 0; j < M; ++j) {
    const int frame = a.frame_indices[vm + j];
    const bool active = a.empty[vm + j] == 0;
    const bool prior_ok = a.has_prior[vm + j] != 0;

    // ---- search bounds (velocity-constrained, monotone rightward) ----
    const bool no_hist = lv_pos < 0;
    const int elapsed = max(1, frame - lv_frame);
    const int s0 = no_hist ? a.edge_margin : lv_pos;
    // int32 wrap-around as in jnp (unsigned arithmetic cannot overflow).
    const int reach = (int)((unsigned)lv_pos + (unsigned)md * (unsigned)elapsed +
                            (unsigned)a.search_window);
    const int s1 = no_hist ? W - a.edge_margin : min(W - a.edge_margin, reach);
    const bool window_nonempty = s1 > s0;

    // ---- candidate ----
    int final_pos;
    const float* row0 = prof0 + (size_t)j * W;
    if (a.method == M_COMBINED) {
      const float* row1 = prof1 + (size_t)j * W;
      float gmin = POS_F, smax = NEG_F;
      int pos_g = BIG_I;
      for (int c = tid; c < W; c += BLOCK) {
        const bool inw = c >= s0 && c < s1;
        const float g = inw ? row1[c] : POS_F;
        if (lt_vc(g, c, gmin, pos_g)) { gmin = g; pos_g = c; }
        smax = fmaxf(smax, inw ? fabsf(row0[c]) : NEG_F);
      }
      red.argmin_and_max(gmin, pos_g, smax);
      const float thr = smax * a.sobel_frac;
      int pos_s = -1;
      for (int c = tid; c < W; c += BLOCK) {
        const bool inw = c >= s0 && c < s1;
        if (inw && fabsf(row0[c]) > thr) pos_s = c;
      }
      pos_s = red.max_int(pos_s);
      const bool g_ok = window_nonempty && gmin < -a.min_grad;
      const bool s_ok = window_nonempty && smax > a.min_grad && pos_s >= 0;
      final_pos = max(g_ok ? pos_g : -1, s_ok ? pos_s : -1);
    } else if (a.method == M_GRADIENT) {
      final_pos = detect_gradient(row0, W, s0, s1, a.min_grad, red);
    } else {
      final_pos = detect_profile_edge(row0, W, s0, s1, a.method == M_HALF_MAXIMUM,
                                      a.method_frac, a.min_grad, red);
    }
    if (!window_nonempty) final_pos = -1;
    if (!(active && prior_ok)) final_pos = -1;
    const bool detected = active && final_pos >= 0;

    // ---- velocities (mirror FlameTracker._update_velocities) ----
    const bool have_prev_entry = active && p1_pos >= 0 && detected;
    const float dt = (float)(frame - p1_frame) / fr;
    const bool vel_ok = have_prev_entry && dt > 0.0f && fr > 0.0f;
    const float v1 = vel_ok ? ((float)(final_pos - p1_pos) * cal) / dt : 0.0f;
    const float nv_prev = vel_ok ? v_latest : v_prev;
    const bool nvp_ok = vel_ok ? vl_ok : vp_ok;
    const float nv_latest = vel_ok ? v1 : v_latest;
    const bool nvl_ok = vel_ok || vl_ok;
    const int nn = n_entries + (vel_ok ? 1 : 0);

    // ---- DDT latch (first v1 jump above threshold) ----
    const bool ddt_hit = vel_ok && ddt < 0 && vl_ok && (v1 - v_latest > a.ddt_jump);
    const int nddt = ddt_hit ? frame : ddt;

    // ---- exit / velocity-drop (advisory latches) ----
    const bool exit_hit = detected && final_pos >= W - a.exit_margin;
    const bool vdrop_hit = active && !exit_hit && nvl_ok && nn >= 1 && nvp_ok &&
                           nn >= 2 && nv_prev > 100.0f &&
                           (nv_prev - nv_latest) / nv_prev > 0.5f;
    const bool stopped_now = exit_hit || vdrop_hit;
    const bool first_stop = stopped_now && !stopped;
    if (first_stop && nn >= 2) clear_vc = nn - 2;
    if (first_stop) {
      stop_step = j;
      stop_reason = exit_hit ? 1 : 2;
    }
    stopped = stopped || stopped_now;

    if (tid == 0) {
      a.final_pos[vm + j] = final_pos;
      a.recorded[vm + j] = (detected && !stopped_now) ? 1 : 0;
      a.is_post[vm + j] = (nddt >= 0 && frame >= nddt) ? 1 : 0;
      a.s0_out[vm + j] = s0;
      a.s1_out[vm + j] = s1;
    }

    // ---- state rollover ----
    if (active) {
      p1_frame = frame;
      p1_pos = final_pos;
    }
    if (detected) {
      lv_pos = final_pos;
      lv_frame = frame;
    }
    v_prev = nv_prev;
    vp_ok = nvp_ok;
    v_latest = nv_latest;
    vl_ok = nvl_ok;
    n_entries = nn;
    ddt = nddt;
  }
  if (tid == 0) {
    a.stop_step[vid] = stop_step;
    a.stop_reason[vid] = stop_reason;
    a.ddt_frame[vid] = ddt;
    a.clear_vc[vid] = clear_vc;
  }
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
  tracking_scan_kernel<<<v, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
