// PL synchronisation and demapping over a batch of frame lanes: a PLHEADER
// kernel and a payload kernel.
//
// No Pallas kernel precedes them. They replace the per-lane PLFRAME
// closure that the JAX package vmaps over lanes and XLA fuses
// (make_lane_fn, dvbs2rx_tpu/parallel/batch.py:51-101; the VCM _lane_fn,
// dvbs2rx_tpu/rx/vcm_stream.py:471-520) and the coarse-CFO
// autocorrelation (coarse_autocorr, dvbs2rx_tpu/ops/plsync.py:284). The
// port's plain versions (ops/plsync_cuda.py plheader_plain and
// payload_plain, composed of ops/plsync.py and ops/demap.py) run them as
// ~110 small launches a step on the CCM path and ~1,300 on the VCM path,
// and the autocorrelation as a float32 GEMM with an (8100, 89) 0/1 lag
// matrix.
//
// plsync_header_kernel: one block per header (lane b, set j), 128
// threads. Thread n < 90 loads header symbol n (any strides) and removes
// its modulation with the conj PLHEADER table row of the header's PLS.
// Warp 0 then sums the 90 products and the last 36 (the data-aided header
// phase and the pilot-mode tail phase, atan2 of the sums) and, when asked,
// the frame metric: the 89 differentials conj(h[m]) h[m - 1] correlated
// with the SOF and PLSC taps, max |sof +- plsc|. When asked (N > 0),
// thread t < N - 1 of the first set's blocks sums lag t + 1 of the
// autocorrelation directly, r[m - 1] = sum_n p[n + m] conj(p[n]) over the
// first N = 90 or 26 modulation-removed symbols (~4,000 complex products a
// header, no lag matrix).
//
// plsync_payload_kernel: one block per lane, 512 threads, a template on
// the constellation. It reads the lane's payload in place (symbol buffer,
// per-lane start clamped into [0, rows - clamp_len] as the step's window
// gather clamps it, any strides), descrambles it, takes the pilot-block
// phases (pilot mode; warps sum the 36 pilots of each block), the fine CFO
// (pilot mode from the header tail phase and the pilot phases, pilotless
// from the two header phases), gated by coarse_corrected. Pass 1
// derotates every data symbol and sums the data-aided SNR terms (QPSK
// sliced; otherwise against the nearest constellation point, tied points
// sharing their energies equally); the block reduces them to n0, and
// n0_use = n0_override if > 0 else n0. Pass 2 derotates again (recomputing
// costs less than storing the symbols), demaps (QPSK and 8PSK in closed
// form, 16/32APSK max-log over the points), rounds half to even, clips to
// int8 and writes each LLR at its deinterleaved codeword position through
// the caller's (position, lane) strides; it writes the corrected symbols
// only for the lanes a caller reads (every x_every-th lane, the first
// x_len symbols, times x_scale). With a lane mask (sel), unselected lanes
// write nothing. No float LLR leaves the kernel.
//
// Numerics. Element-wise products and sums round as the plain version's
// separate launches do (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __frcp_rn:
// no FMA contraction), including PyTorch's forms on the card: a Python
// scalar divided by a tensor is a reciprocal times the scalar, a tensor
// divided by a Python scalar a product with the scalar's reciprocal (the
// wrapper passes those constants). Sums of many terms run in double and
// round once, so they sit within an ulp or two of torch's float32 sums in
// their own order. sin and cos of the derotation phase ph = phase +
// 2 pi f n come from sincos_bounded: a three-part Cody-Waite reduction by
// pi/2 (FMA) and minimax polynomials on [-pi/4, pi/4] (the Cephes sinf and
// cosf coefficients), within 2 ulp of the true values for |ph| < 1e5
// (here |ph| <= pi + 2 pi |f| n <= ~2 pi, since |f| <= 1 / (2 L) pilotless
// and 1 / (2 1476) per 1,440-symbol segment in pilot mode, and f = 0 while
// a lane is not coarse-corrected). CUDA's sinf and cosf keep a stack frame
// for their large-argument path, which these arguments never need.
//
// What bounds them. Header kernel: at 1,344 headers (the VCM step's walked
// slots) ~1 MB read and ~0.5 MB of autocorrelations written, and ~4,000
// complex multiply-adds a header (~5.4 M, ~0.4 us of the float32 rate):
// bytes, ~0.5 us, and a launch. Payload kernel, at the CCM shape (B = 128
// lanes of 32,400 QPSK symbols): the payload once (33.2 MB), the int8 LLRs
// (8.29 MB) and frame 0's corrected symbols (16.6 MB) ~ 58 MB ~ 0.017 ms
// at 3.35 TB/s. This design reads the payload twice (the second pass
// mostly from the 50 MB L2) and writes the lane-major LLRs one byte per
// thread, strided by B: a simple first design, timed beside its bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHdrThreads = 128;
constexpr int kHdr = 90;               // PLHEADER symbols
constexpr int kTaps = 89;              // frame-metric differentials
constexpr int kTail = 36;              // the pilot-mode tail phase's symbols
constexpr int kPayThreads = 512;
constexpr int kPayWarps = kPayThreads / 32;
constexpr int kPilotPeriod = 1476;     // pilot block period, symbols
constexpr int kPilotLen = 36;
constexpr int kSegLen = 1440;          // data symbols between pilot blocks
constexpr int kMaxPilots = 22;
enum Kind { kQPSK = 0, k8PSK = 1, kAPSK = 2 };
// the payload kernel's float constants (plsync_cuda.payload_constants)
enum Const { kTwoPi = 0, kPi, kPi4, kSqrt2_2, kQpskNum, kRotR, kRotI,
             kDist8, kInvFine, kNConst };

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a * b, rounded as torch's cmul rounds each product and sum
__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// atan2 of a double sum rounded to float, as data_aided_phase's atan2 of
// the float32 sum
__device__ __forceinline__ float phase_of(double re, double im) {
  return atan2f((float)im, (float)re);
}

// plsync._wrap: x -= 2 pi above pi, then x += 2 pi below -pi (float32
// constants, as torch compares and subtracts a Python scalar)
__device__ __forceinline__ float wrap_rn(float x, const float* kc) {
  if (x > kc[kPi]) x = __fsub_rn(x, kc[kTwoPi]);
  if (x < -kc[kPi]) x = __fadd_rn(x, kc[kTwoPi]);
  return x;
}

// sin and cos of a, |a| < 1e5: three-part Cody-Waite reduction by pi/2
// with FMA, then minimax polynomials on [-pi/4, pi/4] (Cephes sinf/cosf
// coefficients); within 2 ulp of the true values, no local memory.
__device__ __forceinline__ void sincos_bounded(float a, float* s, float* c) {
  const float q = rintf(a * 0.636619772f);
  const int i = (int)q;
  float r = fmaf(q, -1.5707962512969971e+00f, a);
  r = fmaf(q, -7.5497894158615964e-08f, r);
  r = fmaf(q, -5.3903029534742384e-15f, r);
  const float r2 = r * r;
  float ps = fmaf(r2, -1.9515295891e-4f, 8.3321608736e-3f);
  ps = fmaf(ps, r2, -1.6666654611e-1f);
  ps = fmaf(ps * r2, r, r);
  float pc = fmaf(r2, 2.443315711809948e-5f, -1.388731625493765e-3f);
  pc = fmaf(pc, r2, 4.166664568298827e-2f);
  pc = fmaf(pc * r2, r2, fmaf(-0.5f, r2, 1.0f));
  const float sr = (i & 1) ? pc : ps;
  const float cr = (i & 1) ? ps : pc;
  *s = (i & 2) ? -sr : sr;
  *c = ((i + 1) & 2) ? -cr : cr;
}

__device__ __forceinline__ float2 load2(const float* p, long long sc) {
  return make_float2(__ldg(p), __ldg(p + sc));
}

__device__ __forceinline__ int8_t quantize_rn(float v) {
  // torch.round (half to even), clamp(-128, 127), to int8
  return (int8_t)fminf(fmaxf(rintf(v), -128.0f), 127.0f);
}

// ---------------------------------------------------------------------------
// PLHEADER kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kHdrThreads)
plsync_header_kernel(const float* __restrict__ hdr0,
                     const float* __restrict__ hdr1,
                     const long long* __restrict__ pls0,
                     const long long* __restrict__ pls1,
                     const float2* __restrict__ lut,
                     const float2* __restrict__ taps,
                     float* __restrict__ phase, float* __restrict__ metric,
                     float2* __restrict__ autocorr, int J, int Y,
                     long long sx, long long sy, long long sn, long long sc,
                     int pls_stride, int n_auto) {
  __shared__ float2 h[kHdr];
  __shared__ float2 p[kHdr];
  const int b = blockIdx.x, j = blockIdx.y, t = threadIdx.x;
  const float* base = (j == 0 ? hdr0 : hdr1) +
                      (long long)(b / Y) * sx + (long long)(b % Y) * sy;
  const long long pls = (j == 0 ? pls0 : pls1)[(long long)b * pls_stride];
  if (t < kHdr) {
    const float2 v = load2(base + t * sn, sc);
    h[t] = v;
    p[t] = cmul_rn(v, lut[pls * kHdr + t]);
  }
  __syncthreads();
  const int hj = b * J + j;
  if (t < 32) {
    double ar = 0.0, ai = 0.0, tr = 0.0, ti = 0.0;
    double sr = 0.0, si = 0.0, qr = 0.0, qi = 0.0;
    for (int n = t; n < kHdr; n += 32) {
      ar += p[n].x;
      ai += p[n].y;
      if (n >= kHdr - kTail) {
        tr += p[n].x;
        ti += p[n].y;
      }
      if (metric != nullptr && n >= 1) {
        // d = conj(h[n]) h[n - 1] (plsync.differentials), then d x taps
        const float2 a = h[n], c = h[n - 1];
        const float2 d = make_float2(
            __fadd_rn(__fmul_rn(a.x, c.x), __fmul_rn(a.y, c.y)),
            __fsub_rn(__fmul_rn(a.x, c.y), __fmul_rn(a.y, c.x)));
        const float2 us = cmul_rn(d, taps[n - 1]);
        const float2 up = cmul_rn(d, taps[kTaps + n - 1]);
        sr += us.x;
        si += us.y;
        qr += up.x;
        qi += up.y;
      }
    }
    ar = warp_sum(ar);
    ai = warp_sum(ai);
    tr = warp_sum(tr);
    ti = warp_sum(ti);
    if (metric != nullptr) {
      sr = warp_sum(sr);
      si = warp_sum(si);
      qr = warp_sum(qr);
      qi = warp_sum(qi);
    }
    if (t == 0) {
      phase[2 * hj] = phase_of(ar, ai);
      phase[2 * hj + 1] = phase_of(tr, ti);
      if (metric != nullptr) {
        const float s0 = (float)sr, s1 = (float)si;
        const float q0 = (float)qr, q1 = (float)qi;
        const float pr = __fadd_rn(s0, q0), pi = __fadd_rn(s1, q1);
        const float mr = __fsub_rn(s0, q0), mi = __fsub_rn(s1, q1);
        const float e1 = __fadd_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi));
        const float e2 = __fadd_rn(__fmul_rn(mr, mr), __fmul_rn(mi, mi));
        metric[hj] = fmaxf(__fsqrt_rn(e1), __fsqrt_rn(e2));
      }
    }
  }
  if (j == 0 && t < n_auto - 1) {
    // r[m - 1] = sum_n p[n + m] conj(p[n]); float products are exact in
    // double, so only the sum rounds (once, at the end, to float)
    const int m = t + 1;
    double rr = 0.0, ri = 0.0;
    for (int n = 0; n + m < n_auto; ++n) {
      const float2 a = p[n + m], c = p[n];
      rr += (double)a.x * c.x + (double)a.y * c.y;
      ri += (double)a.y * c.x - (double)a.x * c.y;
    }
    autocorr[(long long)b * (n_auto - 1) + t] =
        make_float2((float)rr, (float)ri);
  }
}

// ---------------------------------------------------------------------------
// Payload kernel
// ---------------------------------------------------------------------------

struct PayloadArgs {
  const float* sym;              // payload source, (x, y, row, comp) strides
  const long long* start;        // per-lane first row, or null (0)
  const float2* descr;           // descrambling sequence, >= Lp entries
  const float* ph;               // (B, 2, 2): own phase, own tail, next
                                 // phase, next tail
  const uint8_t* cc;             // coarse_corrected (B,)
  const float* n0_ov;            // refined N0 (B,), > 0 overrides
  const uint8_t* sel;            // lane mask (B,), or null (every lane)
  const float2* pts;             // constellation points (n_pts)
  const float* kc;               // constants (enum Const)
  int8_t* llr;                   // LLR out, (position, lane) strides
  float2* x_out;                 // corrected symbols out, or null
  float* fine_out;               // (B,)
  float* n0_out;                 // (B,)
  long long sx, sy, sn, sc, rows, l_pos, l_lane;
  int Y, clamp_len, Lp, n_pilots, R, order, x_every, x_len, n0_use_out;
  float x_scale;
};

// the corrected (descrambled, derotated) data symbol i of a lane
__device__ __forceinline__ float2 corrected_symbol(
    const PayloadArgs& a, const float* lane, int i, float phase0,
    const float* pil_ph, float w) {
  int seg = 0, n = i, q = i;
  float phase = phase0;
  if (a.n_pilots > 0) {
    seg = min(i / kSegLen, a.n_pilots);
    n = i - seg * kSegLen;
    q = seg * kPilotPeriod + n;
    if (seg > 0) phase = pil_ph[seg - 1];
  }
  const float2 y = load2(lane + (long long)q * a.sn, a.sc);
  const float2 yd = cmul_rn(y, __ldg(&a.descr[q]));
  // ph = phase + (2 pi f) n, then cexp(-ph)
  const float ph = __fadd_rn(phase, __fmul_rn(w, (float)n));
  float s, c;
  sincos_bounded(-ph, &s, &c);
  return cmul_rn(yd, make_float2(c, s));
}

template <int kKind, int kP>
__global__ void __launch_bounds__(kPayThreads)
plsync_payload_kernel(PayloadArgs a) {
  // bits per symbol; symbols in flight per thread (the points' distances
  // take kP registers each)
  constexpr int kMod = kKind == kQPSK ? 2 : (kKind == k8PSK ? 3
                                              : (kP == 16 ? 4 : 5));
  constexpr int kUnroll = kP <= 8 ? 4 : 1;
  __shared__ float pil_ph[kMaxPilots];
  __shared__ float2 pts[kP];
  __shared__ float energy[kP];
  __shared__ double red[2][kPayWarps];
  __shared__ float lane_f[2];          // 2 pi x gated fine, n0_use
  const int b = blockIdx.x, t = threadIdx.x;
  const int warp = t / 32, ln = t % 32;
  if (a.sel != nullptr && !a.sel[b]) return;
  const float* kc = a.kc;
  long long s = a.start != nullptr ? a.start[b] : 0;
  s = max(0LL, min(s, a.rows - a.clamp_len));
  const float* lane = a.sym + (long long)(b / a.Y) * a.sx +
                      (long long)(b % a.Y) * a.sy + s * a.sn;
  if (kKind != kQPSK && t < kP) {
    const float2 v = a.pts[t];
    pts[t] = v;
    energy[t] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  }
  const float ph_own = a.ph[4 * b], ph_tail = a.ph[4 * b + 1];
  const float ph_next = a.ph[4 * b + 2];
  // pilot-block phases: atan2 of the 36 descrambled pilots, less pi/4
  for (int k = warp; k < a.n_pilots; k += kPayWarps) {
    double pr = 0.0, pi = 0.0;
    for (int m = ln; m < kPilotLen; m += 32) {
      const int q = (k + 1) * kPilotPeriod - kPilotLen + m;
      const float2 v = cmul_rn(load2(lane + (long long)q * a.sn, a.sc),
                               __ldg(&a.descr[q]));
      pr += v.x;
      pi += v.y;
    }
    pr = warp_sum(pr);
    pi = warp_sum(pi);
    if (ln == 0)
      pil_ph[k] = wrap_rn(__fsub_rn(phase_of(pr, pi), kc[kPi4]), kc);
  }
  __syncthreads();
  if (t == 0) {
    float fine;
    if (a.n_pilots > 0) {
      // fine_foffset_pilot_mode: the wrapped steps from the header tail
      float acc = wrap_rn(__fsub_rn(pil_ph[0], ph_tail), kc);
      for (int k = 1; k < a.n_pilots; ++k)
        acc = __fadd_rn(acc, wrap_rn(__fsub_rn(pil_ph[k], pil_ph[k - 1]),
                                     kc));
      fine = __fmul_rn(acc, kc[kInvFine]);
    } else {
      fine = __fmul_rn(wrap_rn(__fsub_rn(ph_next, ph_own), kc),
                       kc[kInvFine]);
    }
    a.fine_out[b] = fine;
    lane_f[0] = __fmul_rn(kc[kTwoPi], a.cc[b] ? fine : 0.0f);
  }
  __syncthreads();
  const float w = lane_f[0];

  // pass 1: data-aided SNR terms
  double sp = 0.0, np = 0.0;
#pragma unroll (kUnroll)
  for (int i = t; i < a.R; i += kPayThreads) {
    const float2 x = corrected_symbol(a, lane, i, ph_own, pil_ph, w);
    if (kKind == kQPSK) {
      const float s2 = kc[kSqrt2_2];
      const float rr = x.x > 0.0f ? s2 : (x.x < 0.0f ? -s2 : 0.0f);
      const float ri = x.y > 0.0f ? s2 : (x.y < 0.0f ? -s2 : 0.0f);
      sp += __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
      const float er = __fsub_rn(x.x, rr), ei = __fsub_rn(x.y, ri);
      np += __fadd_rn(__fmul_rn(er, er), __fmul_rn(ei, ei));
    } else {
      float d2[kP];
      float dmin = INFINITY;
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float dr = __fsub_rn(x.x, pts[k].x);
        const float di = __fsub_rn(x.y, pts[k].y);
        d2[k] = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
        dmin = fminf(dmin, d2[k]);
      }
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kP; ++k) cnt += d2[k] == dmin;
      // tied points share their energies: sum_k (1 / cnt) e_k
      const float inv = __fdiv_rn(1.0f, (float)max(cnt, 1));
      float e = 0.0f;
#pragma unroll
      for (int k = 0; k < kP; ++k)
        if (d2[k] == dmin) e = __fadd_rn(e, __fmul_rn(inv, energy[k]));
      sp += e;
      np += dmin;
    }
  }
  sp = warp_sum(sp);
  np = warp_sum(np);
  if (ln == 0) {
    red[0][warp] = sp;
    red[1][warp] = np;
  }
  __syncthreads();
  if (t == 0) {
    double tsp = 0.0, tnp = 0.0;
    for (int k = 0; k < kPayWarps; ++k) {
      tsp += red[0][k];
      tnp += red[1][k];
    }
    // snr = sp / max(np, 1e-12); n0 = 1 / max(snr, 1e-9) (a reciprocal)
    const float snr = __fdiv_rn((float)tsp, fmaxf((float)tnp, 1e-12f));
    const float n0 = __frcp_rn(fmaxf(snr, 1e-9f));
    const float ov = a.n0_ov[b];
    const float n0u = ov > 0.0f ? ov : n0;
    a.n0_out[b] = a.n0_use_out ? n0u : n0;
    lane_f[1] = n0u;
  }
  __syncthreads();
  const float n0u = lane_f[1];
  const float rcp = __frcp_rn(n0u);
  // QPSK scale 2 sqrt 2 / n0; 8PSK dist x 4 / n0 (reciprocal x scalar)
  const float scale = kKind == kQPSK
                          ? __fmul_rn(rcp, kc[kQpskNum])
                          : __fmul_rn(__fmul_rn(rcp, 4.0f), kc[kDist8]);
  const bool x_lane = a.x_out != nullptr && b % a.x_every == 0;
  float2* xo = x_lane ? a.x_out + (long long)(b / a.x_every) * a.x_len
                      : nullptr;
  int8_t* lo = a.llr + (long long)b * a.l_lane;

  // pass 2: demap, quantize, deinterleave, write
#pragma unroll (kUnroll)
  for (int i = t; i < a.R; i += kPayThreads) {
    const float2 x = corrected_symbol(a, lane, i, ph_own, pil_ph, w);
    if (xo != nullptr && i < a.x_len)
      xo[i] = make_float2(__fmul_rn(x.x, a.x_scale), __fmul_rn(x.y, a.x_scale));
    float v[kMod];
    if (kKind == kQPSK) {
      v[0] = __fmul_rn(x.x, scale);
      v[1] = __fmul_rn(x.y, scale);
    } else if (kKind == k8PSK) {
      const float cr = __fsub_rn(__fmul_rn(x.x, kc[kRotR]),
                                 __fmul_rn(x.y, kc[kRotI]));
      const float ci = __fadd_rn(__fmul_rn(x.x, kc[kRotI]),
                                 __fmul_rn(x.y, kc[kRotR]));
      const float b0 = __fmul_rn(kc[kSqrt2_2],
                                 __fsub_rn(fabsf(cr), fabsf(ci)));
      v[0] = __fmul_rn(b0, scale);
      v[1] = __fmul_rn(cr, scale);
      v[2] = __fmul_rn(ci, scale);
    } else {
      float d2[kP];
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float dr = __fsub_rn(x.x, pts[k].x);
        const float di = __fsub_rn(x.y, pts[k].y);
        d2[k] = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
      }
#pragma unroll
      for (int j = 0; j < kMod; ++j) {
        float m0 = INFINITY, m1 = INFINITY;
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          if ((k >> (kMod - 1 - j)) & 1)
            m1 = fminf(m1, d2[k]);
          else
            m0 = fminf(m0, d2[k]);
        }
        v[j] = __fdiv_rn(__fsub_rn(m1, m0), n0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kMod; ++j) {
      // codeword position: column order[j] of R rows (QPSK: not
      // interleaved, symbol order)
      const long long pos =
          a.order < 0 ? (long long)i * kMod + j
                      : (long long)((a.order >> (4 * j)) & 15) * a.R + i;
      lo[pos * a.l_pos] = quantize_rn(v[j]);
    }
  }
}

}  // namespace

extern "C" int plsync_header_launch(
    const void* hdr0, const void* hdr1, const void* pls0, const void* pls1,
    const void* lut, const void* taps, void* phase, void* metric,
    void* autocorr, int B, int J, int Y, long long sx, long long sy,
    long long sn, long long sc, int pls_stride, int n_auto, void* stream) {
  if (B <= 0 || J < 1 || J > 2 || Y <= 0 || n_auto == 1 || n_auto < 0 ||
      n_auto > kHdr) {
    return (int)cudaErrorInvalidValue;
  }
  plsync_header_kernel<<<dim3(B, J), kHdrThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hdr0, (const float*)hdr1, (const long long*)pls0,
      (const long long*)pls1, (const float2*)lut, (const float2*)taps,
      (float*)phase, (float*)metric, (float2*)autocorr, J, Y, sx, sy, sn, sc,
      pls_stride, n_auto);
  return (int)cudaGetLastError();
}

extern "C" int plsync_payload_launch(
    const void* sym, const void* start, const void* descr, const void* ph,
    const void* cc, const void* n0_ov, const void* sel, const void* pts,
    const void* kc, void* llr, void* x_out, void* fine_out, void* n0_out,
    int B, int Y, long long sx, long long sy, long long sn, long long sc,
    long long rows, int clamp_len, int Lp, int n_pilots, int R, int n_mod,
    int order, long long l_pos, long long l_lane, int x_every, int x_len,
    float x_scale, int n0_use_out, int kind, int n_pts, void* stream) {
  if (B <= 0 || Y <= 0 || R <= 0 || n_pilots < 0 || n_pilots > kMaxPilots ||
      clamp_len < Lp || rows < clamp_len || n_mod < 2 || n_mod > 5 ||
      (x_out != nullptr && (x_every <= 0 || x_len <= 0 || x_len > R))) {
    return (int)cudaErrorInvalidValue;
  }
  PayloadArgs a;
  a.sym = (const float*)sym;
  a.start = (const long long*)start;
  a.descr = (const float2*)descr;
  a.ph = (const float*)ph;
  a.cc = (const uint8_t*)cc;
  a.n0_ov = (const float*)n0_ov;
  a.sel = (const uint8_t*)sel;
  a.pts = (const float2*)pts;
  a.kc = (const float*)kc;
  a.llr = (int8_t*)llr;
  a.x_out = (float2*)x_out;
  a.fine_out = (float*)fine_out;
  a.n0_out = (float*)n0_out;
  a.sx = sx;
  a.sy = sy;
  a.sn = sn;
  a.sc = sc;
  a.rows = rows;
  a.l_pos = l_pos;
  a.l_lane = l_lane;
  a.Y = Y;
  a.clamp_len = clamp_len;
  a.Lp = Lp;
  a.n_pilots = n_pilots;
  a.R = R;
  a.order = order;
  a.x_every = x_every;
  a.x_len = x_len;
  a.n0_use_out = n0_use_out;
  a.x_scale = x_scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == kQPSK && n_pts == 4 && n_mod == 2) {
    plsync_payload_kernel<kQPSK, 4><<<B, kPayThreads, 0, st>>>(a);
  } else if (kind == k8PSK && n_pts == 8 && n_mod == 3) {
    plsync_payload_kernel<k8PSK, 8><<<B, kPayThreads, 0, st>>>(a);
  } else if (kind == kAPSK && n_pts == 16 && n_mod == 4) {
    plsync_payload_kernel<kAPSK, 16><<<B, kPayThreads, 0, st>>>(a);
  } else if (kind == kAPSK && n_pts == 32 && n_mod == 5) {
    plsync_payload_kernel<kAPSK, 32><<<B, kPayThreads, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
