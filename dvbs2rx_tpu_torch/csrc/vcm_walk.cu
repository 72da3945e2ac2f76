// Decoded-PLS chain walk of the VCM stream receiver, one launch per step.
//
// No Pallas kernel precedes it. It replaces the lax.scan of K_max slots of
// VCMStreamReceiver._walk (dvbs2rx_tpu/rx/vcm_stream.py:397-470), which the
// port's plain version (rx/vcm_stream.py VCMStreamReceiver._walk_plain)
// runs as a Python loop of ~240 small launches a slot. Per channel c, from
// the carry (pos, pls, alive, own header, own metric):
//
//   first frame: the 94-symbol window at clamp(fp0 - 2, 0, N_SYM - 94),
//     fp0 = N_SYM - fp_right, its 3-point frame metric m3, the re-align
//     shift (the centre unless a side beats it by more than 1e-3, the first
//     maximum on a tie), pos = fp0 + shift, own = the 90 symbols at
//     shift + 2, alive = have <= pos <= N_SYM - L_max - 92;
//   slot k: the window, metric and shift at pos + L[pls]; the PLSC of that
//     header (differential while the channel is not coarse-corrected, the
//     configured coherent mode after; scores outside the search mask -inf,
//     the first maximum wins); the slot's outputs; then, if alive, the
//     carry moves to the next frame and alive falls once it passes
//     N_SYM - L_max - 92; a dead chain's carry is frozen.
//
// Design: one block of 128 threads per channel walks its chain in order
// (C = 64 blocks on 132 SMs: a latency-bound chain, not throughput). A slot
// stages its window in shared memory (94 float2 from the ring: the 68 MB
// ring is never copied); 93 threads form the differentials, warps 0-2 the
// three 89-term metric correlations (shuffle sums); every thread takes the
// shift from the three metrics. The PLSC: warp 0 the SOF correlation ck
// (26 terms) and 64 threads the soft values derotated by conj(ck) / |ck|
// (no atan2, sin or cos, so no local memory for their large-argument
// path); or warp 0 the 64 differential flips by two ballots and their
// running XOR by popcount. Then thread p scores PLS p against its
// scrambled Reed-Muller image (+-1, kept as 64 bits in two registers; -inf
// where the receiver's search mask is not set) and a butterfly argmax
// over the block picks the first maximum. Element-wise products round as
// the plain version's separate launches do (__fmul_rn etc., no FMA
// contraction); the sums run in another order than torch's, so a float
// decision can differ only at a near-tie (the hard and differential
// scores are exact integers).
// Early stop: once a chain is dead at slot k, every later slot's outputs
// equal slot k's (the carry is frozen, and a slot's outputs depend only on
// the carry, the ring and corrected), so the block computes slot k once and
// writes it to slots k + 1 .. K - 1.
// What bounds it: latency. Per computed slot a dependent chain of the
// differentials, the metric's 89-term sum, the shift, the PLSC (the
// coherent mode's SOF sum and its |ck| first), the 64-term scores, the
// 128-way argmax, and the L table read that addresses the next window:
// ~420 cycles coherent, ~0.2 us. This kernel also waits for each window's
// load (~600 cycles from device memory, less from L2) after the argmax;
// that wait is not irreducible, since the next window starts at
// pos + L[p] + {-1, 0, 1} for p among the few searched PLS, so the loads
// can be issued before the argmax ends. The bytes (~1 MB of windows read,
// ~1.9 MB of headers written at C = 64, K = 21) take ~0.9 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // one thread per PLS candidate
constexpr int kWarps = kThreads / 32;
constexpr int kExt = 94;               // window [pos - 2, pos + 92)
constexpr int kHdr = 90;               // PLHEADER symbols
constexpr int kTaps = 89;              // frame-metric differentials
constexpr int kSof = 26;
constexpr int kPlsc = 64;
constexpr int kPls = 128;
// the wrapper's float table, in float2 entries: SOF and PLSC metric taps,
// the conj SOF symbols, the pi/2-BPSK derotation factors
constexpr int kFKs = 0, kFKp = kTaps, kFSof = 2 * kTaps, kFRot = kFSof + kSof;
constexpr int kFTab = kFRot + kPlsc;
// the wrapper's int table: PLFRAME length per PLS, the scrambled images'
// bits (bit k of word 2p + k / 32 set: image p is -1 at k)
constexpr int kIL = 0, kIImg = kPls;

enum Mode { kSoft = 0, kHard = 1, kDiff = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// conj(a) * b, each product rounded (cplx.conj_mul)
__device__ __forceinline__ float2 conj_mul(float2 a, float2 b) {
  return make_float2(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// a * b (cplx.cmul)
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float cabs(float2 a) {
  return sqrtf(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
}

struct Smem {
  float2 ft[kFTab];
  int L[kPls];
  float2 w[kExt];        // the slot's window
  float2 d[kExt - 1];    // its differentials conj(w[m + 1]) w[m]
  float2 own[kHdr];      // the carry's own header
  float v[kPlsc];        // PLSC values
  float m3[3];
  float2 ck;
  float best_v[kWarps];
  int best_i[kWarps];
};

// Stage the window at clamp(pos - 2, 0, n_sym - 94), compute its 3-point
// metric and return the re-align shift (-1, 0 or 1); sm.m3 holds the
// metrics. Ends after a barrier.
__device__ int window_and_shift(Smem& sm, const float2* __restrict__ ring,
                                int n_sym, long long pos) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  long long p0 = pos - 2;
  p0 = p0 < 0 ? 0 : (p0 > n_sym - kExt ? n_sym - kExt : p0);
  if (t < kExt) sm.w[t] = ring[p0 + t];
  __syncthreads();
  if (t < kExt - 1) sm.d[t] = conj_mul(sm.w[t + 1], sm.w[t]);
  __syncthreads();
  if (warp < 3) {
    // offset o = warp: differentials d[o + 1 + i], i = 0..88
    float sr = 0.f, si = 0.f, pr = 0.f, pi = 0.f;
    for (int i = lane; i < kTaps; i += 32) {
      const float2 x = sm.d[warp + 1 + i];
      const float2 s = cmul(x, sm.ft[kFKs + i]);
      const float2 p = cmul(x, sm.ft[kFKp + i]);
      sr = __fadd_rn(sr, s.x);
      si = __fadd_rn(si, s.y);
      pr = __fadd_rn(pr, p.x);
      pi = __fadd_rn(pi, p.y);
    }
    sr = warp_sum(sr);
    si = warp_sum(si);
    pr = warp_sum(pr);
    pi = warp_sum(pi);
    if (lane == 0) {
      const float a = cabs(make_float2(__fadd_rn(sr, pr), __fadd_rn(si, pi)));
      const float b = cabs(make_float2(__fsub_rn(sr, pr), __fsub_rn(si, pi)));
      sm.m3[warp] = fmaxf(a, b);
    }
  }
  __syncthreads();
  const float m0 = sm.m3[0], m1 = sm.m3[1], m2 = sm.m3[2];
  const float mx = fmaxf(fmaxf(m0, m1), m2);
  if (__fadd_rn(m1, 1e-3f) >= mx) return 0;
  const int am = m0 == mx ? 0 : (m1 == mx ? 1 : 2);   // first maximum
  return am - 1;
}

// PLSC decode of the header sm.w[base .. base + 90): the index of the
// best masked score (first maximum). Ends after a barrier.
__device__ int decode_plsc(Smem& sm, int base, bool coherent, int mode,
                           uint32_t img_lo, uint32_t img_hi, bool enabled) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float2* h = sm.w + base;
  if (coherent) {
    // the SOF correlation ck = sum_j h[j] conj(sof[j]); derotate by its
    // phase
    if (warp == 0) {
      float re = 0.f, im = 0.f;
      if (lane < kSof) {
        const float2 p = cmul(h[lane], sm.ft[kFSof + lane]);
        re = p.x;
        im = p.y;
      }
      re = warp_sum(re);
      im = warp_sum(im);
      if (lane == 0) sm.ck = make_float2(re, im);
    }
    __syncthreads();
    if (t < kPlsc) {
      // exp(-j atan2(ck)) = conj(ck) / |ck|: the plain version's cos and
      // sin of -atan2 within an ulp or two; 1 for ck = 0, as there
      const float2 ck = sm.ck;
      const float mag = hypotf(ck.x, ck.y);
      const float2 e = mag > 0.f ? make_float2(__fdiv_rn(ck.x, mag),
                                               -__fdiv_rn(ck.y, mag))
                                 : make_float2(1.f, 0.f);
      const float2 der = cmul(h[kSof + t], e);
      const float2 r = sm.ft[kFRot + t];
      float v = __fsub_rn(__fmul_rn(der.x, r.x), __fmul_rn(der.y, r.y));
      if (mode == kHard) v = v < 0.f ? -1.f : 1.f;
      sm.v[t] = v;
    }
  } else if (warp == 0) {
    // differential: flips[k] = (Im conj(s[k + 1]) s[k] < 0) ^ (k & 1) over
    // s = h[25 .. 89]; bits = their running XOR; values 1 - 2 bits
    const uint32_t f0 = __ballot_sync(
        0xffffffffu, conj_mul(h[kSof + lane], h[kSof - 1 + lane]).y < 0.f);
    const uint32_t f1 = __ballot_sync(
        0xffffffffu,
        conj_mul(h[kSof + 32 + lane], h[kSof + 31 + lane]).y < 0.f);
    const uint32_t odd = 0xaaaaaaaau;
    const uint32_t g0 = f0 ^ odd, g1 = f1 ^ odd;
    const uint32_t upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
    const int b0 = __popc(g0 & upto) & 1;
    const int b1 = (__popc(g0) + __popc(g1 & upto)) & 1;
    sm.v[lane] = b0 ? -1.f : 1.f;
    sm.v[lane + 32] = b1 ? -1.f : 1.f;
  }
  __syncthreads();
  // thread t scores PLS t: sum_k v[k] image_t[k], image +-1
  float sc = 0.f;
#pragma unroll 8
  for (int k = 0; k < kPlsc; ++k) {
    const uint32_t word = k < 32 ? img_lo : img_hi;
    const float v = sm.v[k];
    sc = __fadd_rn(sc, (word >> (k & 31)) & 1u ? -v : v);
  }
  float bv = enabled ? sc : -INFINITY;
  int bi = t;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    sm.best_v[warp] = bv;
    sm.best_i[warp] = bi;
  }
  __syncthreads();
  float v = sm.best_v[0];
  int idx = sm.best_i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (sm.best_v[w] > v) {
      v = sm.best_v[w];
      idx = sm.best_i[w];
    }
  }
  return idx;
}

__global__ void __launch_bounds__(kThreads)
vcm_walk_kernel(const float2* __restrict__ symbuf,
                const int* __restrict__ fp_right,
                const int* __restrict__ symfill,
                const int* __restrict__ pls_in,
                const uint8_t* __restrict__ corrected,
                const float2* __restrict__ ftab,
                const int* __restrict__ itab,
                const uint8_t* __restrict__ search,
                long long* __restrict__ o_pos,
                long long* __restrict__ o_pls, uint8_t* __restrict__ o_valid,
                float2* __restrict__ o_own, float* __restrict__ o_metric,
                long long* __restrict__ o_next_pls,
                float2* __restrict__ o_next_hdr,
                long long* __restrict__ o_fp_right,
                long long* __restrict__ o_pls_carry,
                int* __restrict__ o_n_walked, int C, int n_sym, int K,
                int l_max, int mode) {
  __shared__ Smem sm;
  const int c = blockIdx.x, t = threadIdx.x;
  const float2* ring = symbuf + (long long)c * n_sym;
  for (int i = t; i < kFTab; i += kThreads) sm.ft[i] = ftab[i];
  for (int i = t; i < kPls; i += kThreads) sm.L[i] = itab[kIL + i];
  const uint32_t img_lo = (uint32_t)itab[kIImg + 2 * t];
  const uint32_t img_hi = (uint32_t)itab[kIImg + 2 * t + 1];
  const bool enabled = search[t] != 0;
  const bool coherent = corrected[c] != 0 && mode != kDiff;
  const long long valid_lim = (long long)n_sym - l_max - 92;
  const long long have = (long long)n_sym - symfill[c];
  __syncthreads();

  // first frame: 3-point re-align and the header
  const long long fp0 = (long long)n_sym - fp_right[c];
  int shift = window_and_shift(sm, ring, n_sym, fp0);
  long long pos = fp0 + shift;
  float m_own = sm.m3[shift + 1];
  if (t < kHdr) sm.own[t] = sm.w[shift + 2 + t];
  bool alive = pos <= valid_lim && pos >= have;
  int pls = pls_in[c];
  int walked = 0;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const long long nxt_nom = pos + sm.L[pls & (kPls - 1)];
    const int sh = window_and_shift(sm, ring, n_sym, nxt_nom);
    const long long nxt = nxt_nom + sh;
    const int next_pls = decode_plsc(sm, sh + 2, coherent, mode, img_lo,
                                     img_hi, enabled);
    const float m_next = sm.m3[sh + 1];
    // slot k's outputs; a dead slot's also go to every later slot
    const int last = alive ? k : K - 1;
    for (int j = k; j <= last; ++j) {
      const long long row = (long long)j * C + c;
      if (t < kHdr) {
        o_own[row * kHdr + t] = sm.own[t];
        o_next_hdr[row * kHdr + t] = sm.w[sh + 2 + t];
      }
      if (t == 0) {
        o_pos[row] = pos;
        o_pls[row] = pls;
        o_valid[row] = alive;
        o_metric[row] = m_own;
        o_next_pls[row] = next_pls;
      }
    }
    if (!alive) break;
    ++walked;
    if (t < kHdr) sm.own[t] = sm.w[sh + 2 + t];
    pos = nxt;
    pls = next_pls;
    m_own = m_next;
    alive = nxt <= valid_lim;
    __syncthreads();
  }
  if (t == 0) {
    o_fp_right[c] = (long long)n_sym - pos;
    o_pls_carry[c] = pls;
    o_n_walked[c] = walked;
  }
}

}  // namespace

extern "C" int vcm_walk_launch(const void* symbuf, const void* fp_right,
                               const void* symfill, const void* pls,
                               const void* corrected, const void* ftab,
                               const void* itab, const void* search,
                               void* pos, void* pls_out,
                               void* valid, void* own, void* metric,
                               void* next_pls, void* next_hdr,
                               void* fp_right_out, void* pls_carry,
                               void* n_walked, int C, int n_sym, int K,
                               int l_max, int mode, void* stream) {
  if (C <= 0 || K <= 0 || n_sym < kExt || l_max <= 0 || mode < kSoft ||
      mode > kDiff) {
    return (int)cudaErrorInvalidValue;
  }
  vcm_walk_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)symbuf, (const int*)fp_right, (const int*)symfill,
      (const int*)pls, (const uint8_t*)corrected, (const float2*)ftab,
      (const int*)itab, (const uint8_t*)search, (long long*)pos,
      (long long*)pls_out, (uint8_t*)valid, (float2*)own, (float*)metric,
      (long long*)next_pls, (float2*)next_hdr, (long long*)fp_right_out,
      (long long*)pls_carry, (int*)n_walked, C, n_sym, K, l_max, mode);
  return (int)cudaGetLastError();
}
