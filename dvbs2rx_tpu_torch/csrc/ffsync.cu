// Feed-forward (Oerder & Meyr) timing estimate and its alpha-beta tracker,
// one block a channel.
//
// Replaces no Pallas kernel. The JAX package computes this as one XLA
// fusion chain: FeedForwardSync's _om_terms, _estimate_tau,
// _estimate_timing_multi and _track_impl (dvbs2rx_tpu/ops/ffsync.py:
// 154-405). The port ran it as ~110 PyTorch launches a step around a
// (2, C, 16, 1024, 12) unfold product; the plain version stays
// (ops/ffsync.py FeedForwardSync._track_plain) and CPU tensors run it.
//
// Per channel: the block is the `len` rows of the channel's buffer from
// start = clamp(start[c], 0, N - len) (jax.lax.dynamic_slice's clamp; 0
// without a start), read in place. Its W windows (the multi-window
// estimate: 16 windows of 1,024 samples at even offsets; the single
// window: the first min(est_window, len) samples) are cut into pieces of
// kPiece samples; a round stages kGroups pieces with their halo (6 samples
// before, 5 after, zeros outside the window, as the JAX "same"-mode
// convolution pads it) into shared memory, and each thread of a piece's
// 128 computes 8 consecutive samples' O&M terms from a register window of
// 19 samples: the centre tap's |x|^2 c^2 and the 12-tap odd branch's
// |o|^2, o[k] = sum_j x[k + 5 - j] h[j], signed (-1)^k, the odd term's
// index 0 masked. Their sums run in double: a warp's over its 256
// samples, then a window's over its pieces' warps in order (no atomics).
// Warp 0 then takes each window's atan2, and lane 0 the unwrap, the
// least-squares slope (multi) or the single estimate, the innovation and
// the alpha-beta update in float32 in the plain version's order; lane s
// each segment's position, whole-sample offset and subfilter index
// (floor(n_subfilt mu)); lane 0 the end position, the slip and
// `consumed`. The block gathers each segment's subfilter taps from the
// bank, and writes tau', rate', initialized' = 1, taps (C, S, L), offsets
// (C, S) and consumed (C,).
//
// Numerics: element-wise steps round as the plain version's launches do
// (__fmul_rn, __fadd_rn, __fdiv_rn); the odd branch's 12-tap sums are FMA
// chains and the window sums double sums in another order than torch's
// float32 ones, so tau and the drift sit within ~1e-6 samples of the plain
// version's, and a subfilter index or a slip differs only where the plain
// value sits at a bin edge.
//
// What bounds it: the windows' bytes, 16,384 samples a channel (8.4 MB at
// C = 64, 2.5 us at 3.35 TB/s); 12 x 2 FMAs a sample. One block a channel
// keeps the tracker's scalar chain (16 atan2s, the slope, the update) in
// one place; at C = 64 it fills 64 of the 132 SMs, each reading 131 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 128;                  // threads a piece
constexpr int kGroups = kThreads / kGroup;   // pieces a round
constexpr int kPer = 8;                      // samples a thread
constexpr int kPiece = kGroup * kPer;        // samples a piece
constexpr int kTaps = 12;                    // odd branch
constexpr int kLead = 6;                     // halo before a piece
constexpr int kHalo = kTaps - 1;             // halo before and after
constexpr int kMaxPieces = 16;               // W x pieces a window
constexpr int kMaxWindows = 16;
constexpr int kMaxSeg = 32;
constexpr int kWarpsPerGroup = kGroup / 32;

// slot of sample i of a staged piece: one slot of padding after every 8,
// so the 16 threads of a half-warp, 8 samples apart, read 16 distinct
// bank pairs
__host__ __device__ constexpr int padded(int i) { return i + (i >> 3); }
constexpr int kSlots = padded(kPiece + kHalo) + 1;

struct TrackArgs {
  const float2* buf;       // (C, N) pairs
  const int* start;        // (C,) or null
  const int* offs;         // (W,) window starts in the block
  const float* wc;         // (W,) window centres in symbols (multi)
  const float* hb;         // (12,) reversed even half-band taps
  const float* bank;       // (n_subfilt, L)
  const float* tau_in;
  const float* rate_in;
  const int* init_in;
  float* tau_out;
  float* rate_out;
  int* init_out;
  float* taps_out;         // (C, S, L)
  int* off_out;            // (C, S)
  int* consumed;           // (C,)
  int N, len, W, wlen, multi, L, n_subfilt, S, seg_len, n_out, sps,
      off_bound;
  float cc, smooth, rate_gain, max_rate, c_sym, two_pi;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// jnp.mod's float arithmetic (ops/cplx.mod): fmod, then a sign fix
__device__ __forceinline__ float mod_rn(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && ((r < 0.f) != (m < 0.f))) r = __fadd_rn(r, m);
  return r;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
ffsync_track_kernel(const TrackArgs a) {
  __shared__ float2 win[kGroups][kSlots];
  __shared__ double2 part[kMaxPieces][kWarpsPerGroup];
  __shared__ float s_tw[kMaxWindows];
  __shared__ float s_tr[2];          // tau0, rate
  __shared__ int s_idx[kMaxSeg];
  const int c = blockIdx.x;
  const int s0 = a.start ? min(max(a.start[c], 0), a.N - a.len) : 0;
  const float2* x = a.buf + (long long)c * a.N + s0;
  const int ppw = (a.wlen + kPiece - 1) / kPiece;     // pieces a window
  const int n_pieces = a.W * ppw;
  const int g = threadIdx.x / kGroup, q = threadIdx.x % kGroup;
  float hb[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) hb[j] = __ldg(a.hb + j);

  for (int p0 = 0; p0 < n_pieces; p0 += kGroups) {
    const int p = p0 + g;
    const int w = p / ppw, k0 = (p - w * ppw) * kPiece;
    __syncthreads();                 // the last round's reads are done
    if (p < n_pieces) {
      const float2* xw = x + __ldg(a.offs + w);
      for (int i = q; i < kPiece + kHalo; i += kGroup) {
        const int k = k0 - kLead + i;
        win[g][padded(i)] = (k >= 0 && k < a.wlen) ? __ldg(xw + k)
                                                   : make_float2(0.f, 0.f);
      }
    }
    __syncthreads();
    if (p < n_pieces) {
      float2 v[kPer + kHalo];
#pragma unroll
      for (int j = 0; j < kPer + kHalo; ++j) v[j] = win[g][padded(kPer * q + j)];
      double re = 0.0, im = 0.0;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int k = k0 + kPer * q + r;
        if (k < a.wlen) {
          const float2 xs = v[r + kLead];
          float o0 = 0.f, o1 = 0.f;
#pragma unroll
          for (int j = 0; j < kTaps; ++j) {
            o0 = fmaf(v[r + j].x, hb[j], o0);
            o1 = fmaf(v[r + j].y, hb[j], o1);
          }
          const float se = __fmul_rn(
              a.cc, __fadd_rn(__fmul_rn(xs.x, xs.x), __fmul_rn(xs.y, xs.y)));
          const float so = __fadd_rn(__fmul_rn(o0, o0), __fmul_rn(o1, o1));
          if (k & 1) {
            re -= se;
            im -= so;
          } else {
            re += se;
            if (k) im += so;
          }
        }
      }
      re = warp_sum(re);
      im = warp_sum(im);
      if ((q & 31) == 0) part[p][q >> 5] = make_double2(re, im);
    }
  }
  __syncthreads();

  const float sps = (float)a.sps, half = 0.5f * sps;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane < a.W) {
      double re = 0.0, im = 0.0;
      for (int p = lane * ppw; p < (lane + 1) * ppw; ++p) {
#pragma unroll
        for (int u = 0; u < kWarpsPerGroup; ++u) {
          re += part[p][u].x;
          im += part[p][u].y;
        }
      }
      // (-atan2(im, re) / (2 pi)) * sps
      const float t = atan2f(__double2float_rn(im), __double2float_rn(re));
      s_tw[lane] = __fmul_rn(__fdiv_rn(-t, a.two_pi), sps);
    }
    __syncwarp();
    if (lane == 0) {
      const float tau = a.tau_in[c], rate0 = a.rate_in[c];
      const bool init = a.init_in[c] > 0;
      const float n_out = (float)a.n_out;
      float tau0, rate;
      if (a.multi) {
        // unwrap, then the least-squares line over the window centres (the
        // loops unrolled to kMaxWindows, so t_un stays in registers)
        float t_un[kMaxWindows];
        t_un[0] = 0.f;
#pragma unroll
        for (int i = 1; i < kMaxWindows; ++i) {
          const float d = __fsub_rn(
              mod_rn(__fadd_rn(__fsub_rn(s_tw[i], s_tw[i - 1]), half), sps),
              half);
          t_un[i] = i < a.W ? __fadd_rn(t_un[i - 1], d) : 0.f;
        }
        float sw = 0.f, st = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxWindows; ++i) {
          if (i < a.W) {
            sw = __fadd_rn(sw, __ldg(a.wc + i));
            st = __fadd_rn(st, t_un[i]);
          }
        }
        const float wbar = __fdiv_rn(sw, (float)a.W);
        const float tbar = __fdiv_rn(st, (float)a.W);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxWindows; ++i) {
          if (i < a.W) {
            const float dw = __fsub_rn(__ldg(a.wc + i), wbar);
            num = __fadd_rn(num, __fmul_rn(dw, __fsub_rn(t_un[i], tbar)));
            den = __fadd_rn(den, __fmul_rn(dw, dw));
          }
        }
        const float slope = __fdiv_rn(num, den);
        const float tau_meas = mod_rn(
            __fsub_rn(__fadd_rn(s_tw[0], tbar), __fmul_rn(slope, wbar)), sps);
        const float rate_meas = clampf(slope, -a.max_rate, a.max_rate);
        const float innov = __fsub_rn(
            mod_rn(__fadd_rn(__fsub_rn(tau_meas, tau), half), sps), half);
        rate = init ? clampf(
                          __fadd_rn(
                              __fadd_rn(rate0,
                                        __fmul_rn(a.rate_gain,
                                                  __fsub_rn(rate_meas,
                                                            rate0))),
                              __fdiv_rn(__fmul_rn(a.rate_gain, innov),
                                        n_out)),
                          -a.max_rate, a.max_rate)
                    : rate_meas;
        tau0 = init ? __fadd_rn(tau, __fmul_rn(a.smooth, innov)) : tau_meas;
      } else {
        const float tau_meas = mod_rn(s_tw[0], sps);
        const float pred = __fadd_rn(tau, __fmul_rn(rate0, a.c_sym));
        const float innov = __fsub_rn(
            mod_rn(__fadd_rn(__fsub_rn(tau_meas, pred), half), sps), half);
        tau0 = init ? __fadd_rn(tau, __fmul_rn(a.smooth, innov)) : tau_meas;
        rate = init ? clampf(__fadd_rn(rate0,
                                       __fdiv_rn(__fmul_rn(a.rate_gain,
                                                           innov),
                                                 n_out)),
                             -a.max_rate, a.max_rate)
                    : 0.f;
      }
      // carry and slips (half-symbol hysteresis deadband [-sps/2, 1.5 sps))
      const float pos_end = __fadd_rn(tau0, __fmul_rn(rate, n_out));
      const bool dead = pos_end >= -half && pos_end < 3.f * half;
      const int slip = dead ? 0 : (int)floorf(__fdiv_rn(
                                      __fadd_rn(pos_end, half), sps));
      a.tau_out[c] = __fsub_rn(pos_end, __fmul_rn((float)slip, sps));
      a.rate_out[c] = rate;
      a.init_out[c] = 1;
      a.consumed[c] = a.n_out * a.sps + slip * a.sps;
      s_tr[0] = tau0;
      s_tr[1] = rate;
    }
    __syncwarp();
    // each segment's subfilter phase at its centre and whole-sample offset
    for (int s = lane; s < a.S; s += 32) {
      const float kc = __fmul_rn((float)s + 0.5f, (float)a.seg_len);
      const float ts = __fadd_rn(s_tr[0], __fmul_rn(s_tr[1], kc));
      const float fb = floorf(ts);
      const int base = (int)fb;
      const float mu = __fsub_rn(ts, fb);
      const int idx = (int)floorf(__fmul_rn((float)a.n_subfilt, mu));
      s_idx[s] = min(max(idx, 0), a.n_subfilt - 1);
      a.off_out[c * a.S + s] = min(max(base + 2, 0), a.off_bound);
    }
  }
  __syncthreads();
  float* taps = a.taps_out + (long long)c * a.S * a.L;
  for (int i = threadIdx.x; i < a.S * a.L; i += kThreads) {
    const int s = i / a.L;
    taps[i] = __ldg(a.bank + s_idx[s] * a.L + (i - s * a.L));
  }
}

}  // namespace

extern "C" int ffsync_piece_samples() { return kPiece; }

extern "C" int ffsync_track_launch(
    const void* buf, const void* start, const void* offs, const void* wc,
    const void* hb, const void* bank, const void* tau_in,
    const void* rate_in, const void* init_in, void* tau_out, void* rate_out,
    void* init_out, void* taps_out, void* off_out, void* consumed, int C,
    int N, int len, int W, int wlen, int multi, int L, int n_subfilt, int S,
    int seg_len, int n_out, int sps, int off_bound, float cc, float smooth,
    float rate_gain, float max_rate, float c_sym, float two_pi,
    void* stream) {
  if (C <= 0 || len < 1 || len > N || W < 1 || W > kMaxWindows ||
      wlen < 1 || wlen > len || (long long)W * ((wlen + kPiece - 1) / kPiece)
      > kMaxPieces || (multi && !wc) || L < 1 || n_subfilt < 1 || S < 1 ||
      S > kMaxSeg || seg_len < 1 || n_out < 1 || sps < 1 || off_bound < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const TrackArgs a{(const float2*)buf, (const int*)start, (const int*)offs,
                    (const float*)wc, (const float*)hb, (const float*)bank,
                    (const float*)tau_in, (const float*)rate_in,
                    (const int*)init_in, (float*)tau_out, (float*)rate_out,
                    (int*)init_out, (float*)taps_out, (int*)off_out,
                    (int*)consumed, N, len, W, wlen, multi, L, n_subfilt, S,
                    seg_len, n_out, sps, off_bound, cc, smooth, rate_gain,
                    max_rate, c_sym, two_pi};
  ffsync_track_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
