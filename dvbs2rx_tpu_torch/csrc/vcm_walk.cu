// Decoded-PLS chain walk of the VCM stream receiver and the step's
// per-slot books, one launch per step.
//
// No Pallas kernel precedes it. It replaces, per channel, the lax.scan of
// K_max slots of VCMStreamReceiver._walk (dvbs2rx_tpu/rx/vcm_stream.py:
// 397-470) and the scans over those slots that follow it in the step:
// the compaction of the data slots into F_pay lanes (:603-624), the lock
// upkeep (:673-685) and the full-PLHEADER coarse CFO (:687-733), with its
// per-slot 89-lag autocorrelation (coarse_autocorr, ops/plsync.py:284).
// The port's plain version is VCMStreamReceiver._walk_books_plain
// (rx/vcm_stream.py): _walk_plain, a Python loop of ~240 small launches a
// slot, then the books in PyTorch, ~1,000 launches a step.
//
// Per channel c, from the carry (pos, pls, alive, own header, own metric):
//   first frame: the 94-symbol window at clamp(fp0 - 2, 0, N_SYM - 94),
//     fp0 = N_SYM - fp_right, its 3-point frame metric m3, the re-align
//     shift (the centre unless a side beats it by more than 1e-3, the
//     first maximum on a tie), pos = fp0 + shift, own = the 90 symbols at
//     shift + 2, alive = have <= pos <= N_SYM - L_max - 92;
//   slot k (while alive, k < K): the window, metric and shift at
//     pos + L[pls]; the PLSC of that header (differential while the
//     channel is not coarse-corrected at step entry, the configured
//     coherent mode after; scores outside the search mask -inf, the first
//     maximum wins); the carry moves to that frame, alive falls once it
//     passes N_SYM - L_max - 92. The carry that leaves is the first frame
//     not walked.
//   books, over the walked slots in order: a slot is data when its PLS is
//     no dummy and enabled; the first F_pay data slots become lanes (pos,
//     PLS, own header, next header and next PLS; zeros in the rest), the
//     data count includes those past F_pay; the lock count (reset by a
//     metric above THRESHOLD_LOCKED, else + 1); the walked metrics' sum,
//     the dummies and the rejected (no dummy, not enabled); the coarse
//     recurrence of the JAX scan body: settle counts down, a slot is
//     skipped while settling uncorrected, else its own header's
//     autocorrelation r[m - 1] = sum_n p[n + m] conj(p[n]) (p the header
//     times its PLS's conj PLHEADER row) adds to the (89,) accumulator and
//     the frame count rises; at coarse_period the estimate fires: the 89
//     lags' atan2, their wrapped first differences weighted by the Mengali
//     window, summed, / 2 pi, clamped to +-0.5; corrected = |est| <
//     FINE_FOFFSET_CORR_RANGE, the accumulator and count restart. The
//     evolving corrected flag is the books' own; the walk's PLSC mode
//     keeps the flag the step started with.
//
// Design: one block of 384 threads per channel (C = 64 blocks on 132
// SMs: a latency-bound chain). A slot is one barrier. Warps 0-2 compute
// the frame metric at the window's three offsets (each lane three taps,
// four shuffle sums); at the same time warps 3-5 decode the PLSC of the
// header at each offset, so that the shift only selects a decode: the
// coherent modes derotate by conj(ck) (ck the 26-term SOF correlation; a
// positive scale, so no |ck| and no division), the differential mode
// takes the 64 flips by two ballots and their running XOR by popcount; a
// lane holds PLSC symbols 2j and 2j + 1, descrambled, and their sum and
// difference; a 32-point Walsh-Hadamard transform of each over the warp
// (five shuffle stages) gives all 128 scores, lane j holding the four of
// its table entries (the PLSC code is the first-order Reed-Muller (32, 6)
// code interleaved with the last bit: a score is +-one transform value,
// the wrapper's table says which); two warp reductions (__reduce_max_sync
// of the scores in an order-keeping unsigned form, __reduce_min_sync of
// the PLS scoring the maximum) pick the first maximum. Warps 6-11 copy
// the slot's own header to shared memory, load its conj PLHEADER row and
// issue the next slot's window loads before this slot's argmax: the
// slot's nominal start pos + L[pls] is known at its beginning, and the
// next one is that plus the shift (-1, 0 or 1) plus L of one of the
// searched PLS, so they issue, by cp.async, one 96-symbol window per
// distinct searched frame length (found once, by __match_any_sync) into a
// ring of three window sets, and the slot keeps the one the decode names
// (a length outside the first eight misses: that window loads after the
// barrier). After the walk the books run over the headers kept in shared
// memory: warp 0's ballots give the lanes, the counts and the lock; four
// groups of three warps sum the autocorrelations, a slot each in turn,
// each thread four lags over a quarter of the symbols (a register window
// of the four p[n + m] slides a symbol a step: two loads for four complex
// products, float32 FMA), the quarters added across adjacent lanes; the
// coarse recurrence runs in slot order, the estimate (one atan2 a lag, a
// double sum) only when a channel fires.
//
// Numerics. Element-wise products round as the plain version's separate
// launches do (__fmul_rn etc., no FMA contraction) but in the lag sums,
// which use FMA; long sums run in another order than torch's (the
// metric's shuffles, the transform's butterfly, the lag sums in float32,
// the estimate's in double), so a float differs from the plain composite
// by an ulp or a few, and a decision on a float can differ only at a
// near-tie: the shift (1e-3 margin), a soft-mode PLSC argmax (the hard and
// differential scores are exact integers), the lock's metric > 25, the
// corrected flag's |est| < FINE_FOFFSET_CORR_RANGE. The accumulator adds
// in slot order in float32, as the plain version's does.
//
// What bounds it: latency. Per walked slot a dependent chain: the PLSC
// decode of the header (the SOF sum and the derotation, or the ballots;
// the transform's five stages; two reductions) beside the metric, then the
// barrier and the selection of the next window; the window's load is off
// the chain, issued a slot ahead. The books add the autocorrelations
// (4,005 complex products a walked slot) and, on a fire, 89 atan2s and a
// sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// in the walk, warps 0-2 the metrics, 3-5 the PLSC decodes, 6-11 the
// copies (two windows' symbols at a time: kThreads - 192 = 2 kWin); after
// it, four groups of three warps the autocorrelations
constexpr int kThreads = 384;
constexpr int kPlsWarps = 4;           // one PLS a thread in the prologue
constexpr int kExt = 94;               // window [pos - 2, pos + 92)
constexpr int kWin = kExt + 2;         // a window for all three shifts
constexpr int kHdr = 90;               // PLHEADER symbols
constexpr int kTaps = 89;              // frame-metric differentials
constexpr int kLags = kHdr - 1;        // autocorrelation lags 1..89
constexpr int kQuads = (kLags + 3) / 4;  // four lags a thread sums
constexpr int kChunks = 4;               // over a quarter of the symbols
constexpr int kChunk = (kLags + kChunks - 1) / kChunks;
constexpr int kSof = 26;
constexpr int kPlsc = 64;
constexpr int kPls = 128;
constexpr int kMaxCand = 8;            // frame lengths prefetched
constexpr int kSets = 3;               // window sets in flight
constexpr int kMaxK = 64;              // slots a step, at most
static_assert(kThreads - 6 * 32 == 2 * kWin, "the copy warps' lanes");
// the wrapper's float table, in float2 entries: SOF and PLSC metric taps,
// the conj SOF symbols, the pi/2-BPSK derotation factors, the coarse
// weights (w, 0), then (pi, 2 pi), (the corrected range, the locked
// threshold), (1 / 2 pi, 0), all float32
constexpr int kFKs = 0, kFKp = kTaps, kFSof = 2 * kTaps, kFRot = kFSof + kSof;
constexpr int kFW = kFRot + kPlsc, kFConst = kFW + kLags;
constexpr int kFTab = kFConst + 3;
// the wrapper's int table: PLFRAME length per PLS; the transform's PLS
// (entry 4 j + 2 b + s: the PLS whose score is (-1)^s T_b[j]); the PLSC
// scrambler's bits (2 words, bit k % 32 of word k / 32); the dummy PLS's
// bits (4 words)
constexpr int kIL = 0, kIWht = kPls, kIScr = 2 * kPls, kIDummy = kIScr + 2;

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
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ long long clampll(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

struct Smem {
  float2 ft[kFTab];
  uint8_t srch[kPls];
  uint8_t kind[kPls];          // bit 0: a dummy PLS, bit 1: enabled
  int cand_L[kMaxCand];
  int wkeys[kPlsWarps][32];    // each warp's distinct searched lengths
  int wcount[kPlsWarps];
  float2 win[kSets][kMaxCand][kWin];
  float2 miss[2][kWin];        // windows of a length outside cand_L
  int info[kPls];              // L[p] | (index of L[p] in cand_L + 1) << 20
  int2 rec[2][3];              // a slot's metric and decode at each
                               // offset (by slot parity)
  long long pos[kMaxK + 1];    // walked slots' starts
  int pls[kMaxK + 1];          // their PLS (pls[n_walked]: the carry's)
  float metric[kMaxK + 1];     // their own frame metrics
  int lane_slot[kMaxK];        // the slot in each lane, or -1
  float ang[kLags];
  float term[kLags];
  float est;
};

// one warp: the frame metric at offset o of the window w (94 symbols):
// the 89 differentials d[o + 1 + i] = conj(w[o + 2 + i]) w[o + 1 + i]
// against the SOF and PLSC taps, max |sof +- plsc|; every lane returns it
__device__ __forceinline__ float metric1(const Smem& sm, const float2* w,
                                         int o) {
  const int lane = threadIdx.x & 31;
  float sr = 0.f, si = 0.f, pr = 0.f, pi = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = lane + 32 * j;
    if (i < kTaps) {
      const float2 d = conj_mul(w[o + 2 + i], w[o + 1 + i]);
      const float2 s = cmul(d, sm.ft[kFKs + i]), p = cmul(d, sm.ft[kFKp + i]);
      sr = __fadd_rn(sr, s.x);
      si = __fadd_rn(si, s.y);
      pr = __fadd_rn(pr, p.x);
      pi = __fadd_rn(pi, p.y);
    }
  }
  sr = warp_sum(sr);
  si = warp_sum(si);
  pr = warp_sum(pr);
  pi = warp_sum(pi);
  const float a = cabs(make_float2(__fadd_rn(sr, pr), __fadd_rn(si, pi)));
  const float b = cabs(make_float2(__fsub_rn(sr, pr), __fsub_rn(si, pi)));
  return fmaxf(a, b);
}

// a float's bits as an unsigned of the same order (-0 as +0; not NaN)
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the re-align shift (-1, 0 or 1) of three metrics
__device__ __forceinline__ int shift_of(float m0, float m1, float m2) {
  const float mx = fmaxf(fmaxf(m0, m1), m2);
  if (__fadd_rn(m1, 1e-3f) >= mx) return 0;
  return (m0 == mx ? 0 : (m1 == mx ? 1 : 2)) - 1;   // first maximum
}

// one warp: the PLSC decode of the header h (90 symbols); every lane
// returns the PLS of the first maximum among the searched
__device__ __forceinline__ int decode_plsc(const Smem& sm, const float2* h,
                                           bool coherent, int mode,
                                           const int* pls4, unsigned srch4,
                                           unsigned scr2) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  float v0, v1;                     // PLSC values 2 lane and 2 lane + 1
  if (coherent) {
    // ck = sum_j h[j] conj(sof[j]); derotate by conj(ck) / |ck| (the
    // plain version's cos and sin of -atan2 within an ulp or two; 1 for
    // ck = 0, as there)
    float re = 0.f, im = 0.f;
    if (lane < kSof) {
      const float2 p = cmul(h[lane], sm.ft[kFSof + lane]);
      re = p.x;
      im = p.y;
    }
    re = warp_sum(re);
    im = warp_sum(im);
    // conj(ck), not conj(ck) / |ck|: a positive scale of every value
    // leaves the signs (hard) and the argmax (soft) as they are
    const float2 e = (re != 0.f || im != 0.f) ? make_float2(re, -im)
                                               : make_float2(1.f, 0.f);
    const int k0 = 2 * lane;
    const float2 d0 = cmul(h[kSof + k0], e), d1 = cmul(h[kSof + k0 + 1], e);
    const float2 r0 = sm.ft[kFRot + k0], r1 = sm.ft[kFRot + k0 + 1];
    v0 = __fsub_rn(__fmul_rn(d0.x, r0.x), __fmul_rn(d0.y, r0.y));
    v1 = __fsub_rn(__fmul_rn(d1.x, r1.x), __fmul_rn(d1.y, r1.y));
    if (mode == kHard) {
      v0 = v0 < 0.f ? -1.f : 1.f;
      v1 = v1 < 0.f ? -1.f : 1.f;
    }
  } else {
    // flips[k] = (Im conj(s[k + 1]) s[k] < 0) ^ (k & 1) over s = h[25 ..
    // 89]; bits = their running XOR; values 1 - 2 bits
    const uint32_t f0 = __ballot_sync(
        full, conj_mul(h[kSof + lane], h[kSof - 1 + lane]).y < 0.f);
    const uint32_t f1 = __ballot_sync(
        full, conj_mul(h[kSof + 32 + lane], h[kSof + 31 + lane]).y < 0.f);
    const uint64_t g =
        (((uint64_t)f1 << 32) | f0) ^ 0xaaaaaaaaaaaaaaaaull;
    const int k0 = 2 * lane;
    const uint64_t upto0 = (2ull << k0) - 1ull;
    const uint64_t upto1 = k0 + 1 == 63 ? ~0ull : (2ull << (k0 + 1)) - 1ull;
    v0 = (__popcll(g & upto0) & 1) ? -1.f : 1.f;
    v1 = (__popcll(g & upto1) & 1) ? -1.f : 1.f;
  }
  // descramble, then the pair's sum and difference
  if (scr2 & 1u) v0 = -v0;
  if (scr2 & 2u) v1 = -v1;
  float t0 = __fadd_rn(v0, v1), t1 = __fsub_rn(v0, v1);
  // Walsh-Hadamard transforms over the warp: t_b[j] = sum_m u_b[m]
  // (-1)^popc(m & j)
#pragma unroll
  for (int h2 = 1; h2 < 32; h2 <<= 1) {
    const float o0 = __shfl_xor_sync(full, t0, h2);
    const float o1 = __shfl_xor_sync(full, t1, h2);
    if (lane & h2) {
      t0 = __fsub_rn(o0, t0);
      t1 = __fsub_rn(o1, t1);
    } else {
      t0 = __fadd_rn(t0, o0);
      t1 = __fadd_rn(t1, o1);
    }
  }
  // this lane's four scores (entry q = 2 b + s) in an order-keeping
  // unsigned form, the warp's maximum by one reduction, then the least
  // PLS scoring it (the first maximum) by another
  unsigned u[4], best = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float tb = (q & 2) ? t1 : t0;
    u[q] = ordered(((srch4 >> q) & 1u) ? ((q & 1) ? -tb : tb) : -INFINITY);
    best = u[q] > best ? u[q] : best;
  }
  best = __reduce_max_sync(full, best);
  unsigned least = kPls;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (u[q] == best && (unsigned)pls4[q] < least) least = pls4[q];
  return (int)__reduce_min_sync(full, least);
}

// sum_n p[n + m] conj(p[n]) over n in [n0, n0 + kChunk) (and n < 90 - m)
// for the four lags m0 .. m0 + 3 of one header p (90 symbols; zeros past
// its end): a window of the four p[n + m] in registers slides by one
// symbol a step, so a step loads two symbols for four complex products
// (FMA, float32)
__device__ __forceinline__ void lag_quad(const float2* p, int m0, int n0,
                                         float2* s) {
  const float2 zero = make_float2(0.f, 0.f);
  float2 w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = n0 + m0 + j < kHdr ? p[n0 + m0 + j] : zero;
    s[j] = zero;
  }
  const int n1 = min(n0 + kChunk, kHdr - m0);
  for (int n = n0; n < n1; ++n) {
    const float2 c = p[n];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j].x = fmaf(w[j].x, c.x, fmaf(w[j].y, c.y, s[j].x));
      s[j].y = fmaf(w[j].y, c.x, fmaf(-w[j].x, c.y, s[j].y));
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) w[j] = w[j + 1];
    w[3] = n + m0 + 4 < kHdr ? p[n + m0 + 4] : zero;
  }
}

// thread lt of a group of whole warps: item lt of slot k's
// autocorrelation (lags 4 q + 1 .. 4 q + 4, q = lt / kChunks, over the
// symbol quarter lt % kChunks; items past the last quad sum nothing), its
// four partial sums added over the item's kChunks adjacent lanes, into rr
__device__ __forceinline__ void lag_items(const float2* pf, float2* rr,
                                          int k, int lt) {
  const int q = lt / kChunks, ch = lt - q * kChunks;
  float2 sq[4];
  lag_quad(pf + k * kHdr, 4 * q + 1, ch * kChunk, sq);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 1; h < kChunks; h <<= 1) {
      sq[j].x = __fadd_rn(sq[j].x, __shfl_xor_sync(0xffffffffu, sq[j].x, h));
      sq[j].y = __fadd_rn(sq[j].y, __shfl_xor_sync(0xffffffffu, sq[j].y, h));
    }
  if (ch == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < kLags) rr[k * kLags + 4 * q + j] = sq[j];
}

// plsync._wrap: x -= 2 pi above pi, then x += 2 pi below -pi (float32
// constants, as torch compares and subtracts a Python scalar)
__device__ __forceinline__ float wrap_rn(float x, float pi, float two_pi) {
  if (x > pi) x = __fsub_rn(x, two_pi);
  if (x < -pi) x = __fadd_rn(x, two_pi);
  return x;
}

struct Args {
  const float2* symbuf;
  const int *fp_right, *symfill, *pls, *unlock, *frames, *settle;
  const uint8_t* corrected;
  const float2* acc;
  const float* foffset;
  const float2 *ftab, *lut;
  const int* itab;
  const uint8_t *search, *enabled;
  // lanes (C, F_pay)
  long long *l_pos, *l_pls, *l_next_pls;
  uint8_t* l_valid;
  float2 *l_own, *l_next;
  // per channel
  long long *o_fp_right, *o_pls;
  int *o_n_walked, *o_unlock, *o_frames, *o_settle, *o_counts, *o_dummies,
      *o_rejected;
  float2* o_acc;
  float *o_foffset, *o_metric_sum;
  uint8_t *o_corrected, *o_new_coarse;
  int C, n_sym, K, FP, l_max, mode, coarse_period;
};

__global__ void __launch_bounds__(kThreads)
vcm_walk_kernel(const Args a) {
  __shared__ Smem sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int K = a.K;
  float2* pf = reinterpret_cast<float2*>(dyn);              // K x 90
  float2* hdr = pf + K * kHdr;                              // (K + 1) x 90
  float2* rr = hdr + (K + 1) * kHdr;                        // K x 89
  const int c = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
  const long long n_sym = a.n_sym;
  const float2* ring = a.symbuf + (long long)c * n_sym;

  // the first frame's window and the first slot's (for all three shifts)
  // leave at once
  const long long fp0 = n_sym - a.fp_right[c];
  const int pls_first = a.pls[c];
  const long long p_first = clampll(fp0 - 2, n_sym - kExt);
  // a_next: the base of the window the next slot reads
  long long a_next = clampll(
      fp0 + a.itab[kIL + (pls_first & (kPls - 1))] - 3, n_sym - kWin);
  if (t < kExt) cp_async8(&sm.win[2][0][t], ring + p_first + t);
  if (t >= kExt && t < kExt + kWin)
    cp_async8(&sm.win[0][0][t - kExt], ring + a_next + t - kExt);
  cp_async_commit();

  for (int i = t; i < kFTab; i += kThreads) sm.ft[i] = a.ftab[i];
  const int tp = t & (kPls - 1);          // the PLS of threads t < 128
  const int L_t = a.itab[kIL + tp];
  const bool s_t = t < kPls && a.search[tp] != 0;
  if (t < kPls) {
    sm.srch[t] = s_t;
    sm.kind[t] = ((a.itab[kIDummy + (t >> 5)] >> (t & 31)) & 1) |
                 (a.enabled[t] != 0 ? 2 : 0);
  }
  // this lane's transform entries and scrambler bits (the decode warps)
  int pls4[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pls4[q] = a.itab[kIWht + 4 * lane + q];
  const uint32_t scr_word = (uint32_t)a.itab[kIScr + (lane >> 4)];
  const unsigned scr2 = (scr_word >> (2 * (lane & 15))) & 3u;
  const bool coherent = a.corrected[c] != 0 && a.mode != kDiff;
  // the distinct frame lengths of the searched PLS: each warp's first
  // lane of a length (__match_any_sync), kept where no earlier warp has
  // that length (warps 0-3, one PLS a thread)
  const int key = s_t ? L_t : -1;
  const unsigned same = __match_any_sync(full, key);
  const bool lead = key >= 0 && __ffs(same) - 1 == lane;
  const unsigned leads = __ballot_sync(full, lead);
  if (warp < kPlsWarps) {
    if (lead) sm.wkeys[warp][__popc(leads & below)] = key;
    if (lane == 0) sm.wcount[warp] = __popc(leads);
  }
  __syncthreads();
  unsigned srch4 = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) srch4 |= (unsigned)sm.srch[pls4[q]] << q;
  bool first = lead;
  for (int w = 0; w < warp && w < kPlsWarps; ++w)
    for (int i = 0; i < sm.wcount[w]; ++i)
      if (sm.wkeys[w][i] == key) first = false;
  const unsigned firsts = __ballot_sync(full, first);
  __syncthreads();
  if (warp < kPlsWarps && lane == 0) sm.wcount[warp] = __popc(firsts);
  __syncthreads();
  int idx = __popc(firsts & below), total = 0;
  for (int w = 0; w < kPlsWarps; ++w) {
    if (w < warp) idx += sm.wcount[w];
    total += sm.wcount[w];
  }
  if (first && idx < kMaxCand) sm.cand_L[idx] = L_t;
  const int n_cand = total < kMaxCand ? total : kMaxCand;
  __syncthreads();
  int ci = -1;
  for (int i = 0; i < n_cand; ++i)
    if (sm.cand_L[i] == L_t) ci = i;
  if (t < kPls) sm.info[t] = L_t | ((ci + 1) << 20);
  // the candidate lengths, in registers (the copy warps issue their
  // windows; unused ones 0)
  int cand_L[kMaxCand];
#pragma unroll
  for (int i = 0; i < kMaxCand; ++i) cand_L[i] = i < n_cand ? sm.cand_L[i] : 0;
  cp_async_wait_all();
  __syncthreads();

  // first frame: 3-point re-align and the header (metric warp o: offset o)
  if (warp < 3) {
    const float m = metric1(sm, &sm.win[2][0][0], warp);
    if (lane == 0) sm.rec[1][warp].x = __float_as_int(m);
  }
  __syncthreads();
  float m0 = __int_as_float(sm.rec[1][0].x);
  float m1 = __int_as_float(sm.rec[1][1].x);
  float m2 = __int_as_float(sm.rec[1][2].x);
  int shift = shift_of(m0, m1, m2);
  long long pos = fp0 + shift;
  float m_own = shift == 0 ? m1 : (shift < 0 ? m0 : m2);
  const long long valid_lim = n_sym - a.l_max - 92;
  bool alive = pos <= valid_lim && pos >= n_sym - a.symfill[c];
  int pls = pls_first;
  int L_cur = sm.info[pls & (kPls - 1)] & 0xfffff;
  const float2* win = &sm.win[0][0][0];   // this slot's window, base a_next
  const float2* prev_hdr = &sm.win[2][0][shift + 2];   // to copy: H_k
  int walked = 0;

  for (int k = 0; k < K && alive; ++k) {
    const int par = k & 1;
    const long long nxt_nom = pos + L_cur;
    const float2* w =
        win + (clampll(nxt_nom - 2, n_sym - kExt) - a_next);
    if (warp < 3) {
      // metric warp o: the metric at offset o
      const float m = metric1(sm, w, warp);
      if (lane == 0) sm.rec[par][warp].x = __float_as_int(m);
    } else if (warp < 6) {
      // decode warp o + 3: the PLSC of the header at offset o
      const int o = warp - 3;
      const int d = decode_plsc(sm, w + o + 1, coherent, a.mode, pls4, srch4,
                                scr2);
      if (lane == 0) sm.rec[par][o].y = d | (sm.info[d] << 7);
    } else {
      // copy warps (6-11, 192 lanes, two windows' symbols at a time):
      // the next slot's candidate windows (one per searched frame length;
      // window 2 j + cl / kWin, symbol cl % kWin), this slot's own header
      // and its conj PLHEADER row
      const int cl = t - 6 * 32, e = cl < kWin ? cl : cl - kWin;
      if (k + 1 < K) {
        float2* set = &sm.win[(k + 1) % kSets][0][0];
#pragma unroll
        for (int j = 0; j < kMaxCand / 2; ++j) {
          const int cc = 2 * j + (cl >= kWin);
          if (cc < n_cand) {
            const int Lc = cl >= kWin ? cand_L[2 * j + 1] : cand_L[2 * j];
            const long long base = clampll(nxt_nom + Lc - 3, n_sym - kWin);
            cp_async8(set + cc * kWin + e, ring + base + e);
          }
        }
      }
      if (cl < kHdr) hdr[k * kHdr + cl] = prev_hdr[cl];
      if (cl >= kWin && cl < kWin + kHdr / 2)
        cp_async16(pf + k * kHdr + 2 * (cl - kWin),
                   a.lut + (pls & (kPls - 1)) * kHdr + 2 * (cl - kWin));
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    // slot k walked: its record, then the carry moves to the next frame
    const int2 r0 = sm.rec[par][0], r1 = sm.rec[par][1],
               r2 = sm.rec[par][2];
    m0 = __int_as_float(r0.x);
    m1 = __int_as_float(r1.x);
    m2 = __int_as_float(r2.x);
    shift = shift_of(m0, m1, m2);
    if (t == 0) {
      sm.pos[k] = pos;
      sm.pls[k] = pls;
      sm.metric[k] = m_own;
    }
    ++walked;
    prev_hdr = w + shift + 2;
    pos = nxt_nom + shift;
    const int sel = shift == 0 ? r1.y : (shift < 0 ? r0.y : r2.y);
    pls = sel & (kPls - 1);
    L_cur = (sel >> 7) & 0xfffff;
    m_own = shift == 0 ? m1 : (shift < 0 ? m0 : m2);
    alive = pos <= valid_lim;
    if (!alive || k + 1 == K) break;
    // the next slot's window: a prefetched candidate, or a miss
    a_next = clampll(nxt_nom + L_cur - 3, n_sym - kWin);
    const int cc = (sel >> 27) - 1;
    if (cc >= 0) {
      win = &sm.win[(k + 1) % kSets][cc][0];
    } else {
      float2* m = &sm.miss[(k + 1) & 1][0];
      if (t < kWin) cp_async8(m + t, ring + a_next + t);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      win = m;
    }
  }
  if (t == 0) {
    sm.pos[walked] = pos;
    sm.pls[walked] = pls;
  }
  if (t < kHdr) hdr[walked * kHdr + t] = prev_hdr[t];
  __syncthreads();
  // the walked headers without their modulation (pf holds each walked
  // slot's conj PLHEADER row)
  for (int i = t; i < walked * kHdr; i += kThreads)
    pf[i] = cmul(hdr[i], pf[i]);
  __syncthreads();

  // ---- books ----
  // warp 0: the slots' kinds by ballot (lane j holds slots j and j + 32):
  // the lanes' slots, the counts, the lock; lane 0 the metric sum
  const int FP = a.FP;
  if (warp == 0) {
    const float thr = sm.ft[kFConst + 1].y;
    unsigned dat[2], dum[2], rej[2], rst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      const bool act = k < walked;
      const int kind = act ? sm.kind[sm.pls[k] & (kPls - 1)] : 0;
      const bool dummy = kind & 1, enabled = kind & 2;
      dat[h] = __ballot_sync(full, act && !dummy && enabled);
      dum[h] = __ballot_sync(full, act && dummy);
      rej[h] = __ballot_sync(full, act && !dummy && !enabled);
      rst[h] = __ballot_sync(full, act && sm.metric[k] > thr);
    }
    const int counts = __popc(dat[0]) + __popc(dat[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rank = __popc(dat[h] & below) + (h ? __popc(dat[0]) : 0);
      if (((dat[h] >> lane) & 1u) && rank < FP)
        sm.lane_slot[rank] = lane + 32 * h;
    }
    for (int f = counts + lane; f < FP; f += 32) sm.lane_slot[f] = -1;
    if (lane == 0) {
      // the lock count restarts at the last slot with a strong metric
      const unsigned long long r64 =
          ((unsigned long long)rst[1] << 32) | rst[0];
      const int unlock =
          r64 ? walked - 1 - (63 - __clzll(r64)) : a.unlock[c] + walked;
      float msum = 0.f;
      for (int k = 0; k < walked; ++k) msum = __fadd_rn(msum, sm.metric[k]);
      a.o_n_walked[c] = walked;
      a.o_unlock[c] = unlock;
      a.o_counts[c] = counts;
      a.o_dummies[c] = __popc(dum[0]) + __popc(dum[1]);
      a.o_rejected[c] = __popc(rej[0]) + __popc(rej[1]);
      a.o_metric_sum[c] = msum;
      a.o_fp_right[c] = n_sym - pos;
      a.o_pls[c] = pls;
    }
  }
  // the autocorrelations: four groups of three warps, a slot each in turn
  const int g = warp / 3;
  for (int k = g; k < walked; k += kThreads / 96)
    lag_items(pf, rr, k, t - 96 * g);
  __syncthreads();
  // the lanes
  const long long lane0 = (long long)c * FP;
  for (int i = t; i < FP * kHdr; i += kThreads) {
    const int f = i / kHdr, n = i - f * kHdr;
    const int k = sm.lane_slot[f];
    const long long o = (lane0 + f) * kHdr + n;
    a.l_own[o] = k >= 0 ? hdr[k * kHdr + n] : make_float2(0.f, 0.f);
    a.l_next[o] = k >= 0 ? hdr[(k + 1) * kHdr + n] : make_float2(0.f, 0.f);
  }
  if (t < FP) {
    const int k = sm.lane_slot[t];
    a.l_pos[lane0 + t] = k >= 0 ? sm.pos[k] : 0;
    a.l_pls[lane0 + t] = k >= 0 ? sm.pls[k] : 0;
    a.l_next_pls[lane0 + t] = k >= 0 ? sm.pls[k + 1] : 0;
    a.l_valid[lane0 + t] = k >= 0;
  }

  // the coarse recurrence in slot order; thread m < 89 holds lag m + 1
  const float pi = sm.ft[kFConst].x, two_pi = sm.ft[kFConst].y;
  const float range = sm.ft[kFConst + 1].x, inv_two_pi = sm.ft[kFConst + 2].x;
  float2 acc = t < kLags ? a.acc[(long long)c * kLags + t]
                         : make_float2(0.f, 0.f);
  int settle = a.settle[c], cf = a.frames[c];
  bool corrected = a.corrected[c] != 0, new_coarse = false;
  float est = a.foffset[c];
  for (int k = 0; k < K; ++k) {
    const bool act = k < walked;
    if (!act && cf < a.coarse_period) break;   // nothing changes any more
    const bool in_settle = settle > 0;
    if (act && in_settle) --settle;
    const bool skip = !act || (in_settle && !corrected);
    if (!skip) {
      if (t < kLags) {
        const float2 r = rr[k * kLags + t];
        acc = make_float2(__fadd_rn(acc.x, r.x), __fadd_rn(acc.y, r.y));
      }
      ++cf;
    }
    if (cf >= a.coarse_period) {
      // the estimate: wrapped first differences of the lags' angles,
      // weighted, summed
      if (t < kLags) sm.ang[t] = atan2f(acc.y, acc.x);
      __syncthreads();
      if (t < kLags) {
        const float prev = t > 0 ? sm.ang[t - 1] : 0.f;
        const float d = wrap_rn(__fsub_rn(sm.ang[t], prev), pi, two_pi);
        sm.term[t] = __fmul_rn(d, sm.ft[kFW + t].x);
      }
      __syncthreads();
      if (warp == 0) {
        double s = 0.0;
        for (int m = lane; m < kLags; m += 32) s += (double)sm.term[m];
#pragma unroll
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(full, s, o);
        const float e = __fmul_rn((float)s, inv_two_pi);
        if (lane == 0) sm.est = fminf(fmaxf(e, -0.5f), 0.5f);
      }
      __syncthreads();
      est = sm.est;
      corrected = fabsf(est) < range;
      acc = make_float2(0.f, 0.f);
      cf = 0;
      new_coarse = true;
    }
  }
  if (t < kLags) a.o_acc[(long long)c * kLags + t] = acc;
  if (t == 0) {
    a.o_frames[c] = cf;
    a.o_settle[c] = settle;
    a.o_corrected[c] = corrected;
    a.o_foffset[c] = est;
    a.o_new_coarse[c] = new_coarse;
  }
}

}  // namespace

// the dynamic shared memory of K slots: the walked headers without their
// modulation, the K + 1 headers, the autocorrelations
static int vcm_walk_smem_bytes(int K) {
  return (K * kHdr + (K + 1) * kHdr + K * kLags) * (int)sizeof(float2);
}

extern "C" int vcm_walk_launch(
    const void* symbuf, const void* fp_right, const void* symfill,
    const void* pls, const void* corrected, const void* unlock,
    const void* acc, const void* frames, const void* settle,
    const void* foffset, const void* ftab, const void* itab, const void* lut,
    const void* search, const void* enabled, void* l_pos, void* l_pls,
    void* l_next_pls, void* l_valid, void* l_own, void* l_next,
    void* o_fp_right, void* o_pls, void* o_ints, void* o_acc, void* o_floats,
    void* o_flags, int C, int n_sym, int K, int FP, int l_max, int mode,
    int coarse_period, void* stream) {
  if (C <= 0 || K <= 0 || K > kMaxK || FP <= 0 || FP > kMaxK ||
      n_sym < kWin || l_max <= 0 || mode < kSoft || mode > kDiff) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.symbuf = (const float2*)symbuf;
  a.fp_right = (const int*)fp_right;
  a.symfill = (const int*)symfill;
  a.pls = (const int*)pls;
  a.corrected = (const uint8_t*)corrected;
  a.unlock = (const int*)unlock;
  a.acc = (const float2*)acc;
  a.frames = (const int*)frames;
  a.settle = (const int*)settle;
  a.foffset = (const float*)foffset;
  a.ftab = (const float2*)ftab;
  a.itab = (const int*)itab;
  a.lut = (const float2*)lut;
  a.search = (const uint8_t*)search;
  a.enabled = (const uint8_t*)enabled;
  a.l_pos = (long long*)l_pos;
  a.l_pls = (long long*)l_pls;
  a.l_next_pls = (long long*)l_next_pls;
  a.l_valid = (uint8_t*)l_valid;
  a.l_own = (float2*)l_own;
  a.l_next = (float2*)l_next;
  a.o_fp_right = (long long*)o_fp_right;
  a.o_pls = (long long*)o_pls;
  int* ints = (int*)o_ints;     // (7, C): walked, lock, frames, settle,
  a.o_n_walked = ints;          // data count, dummies, rejected
  a.o_unlock = ints + C;
  a.o_frames = ints + 2 * C;
  a.o_settle = ints + 3 * C;
  a.o_counts = ints + 4 * C;
  a.o_dummies = ints + 5 * C;
  a.o_rejected = ints + 6 * C;
  a.o_acc = (float2*)o_acc;
  float* floats = (float*)o_floats;   // (2, C): coarse estimate, metric sum
  a.o_foffset = floats;
  a.o_metric_sum = floats + C;
  uint8_t* flags = (uint8_t*)o_flags;  // (2, C): corrected, fired
  a.o_corrected = flags;
  a.o_new_coarse = flags + C;
  a.C = C;
  a.n_sym = n_sym;
  a.K = K;
  a.FP = FP;
  a.l_max = l_max;
  a.mode = mode;
  a.coarse_period = coarse_period;
  const int smem = vcm_walk_smem_bytes(K);
  const cudaError_t e = cudaFuncSetAttribute(
      vcm_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  vcm_walk_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
