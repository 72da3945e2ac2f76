// PL synchronisation and demapping over a batch of frame lanes: a PLHEADER
// kernel and the payload's two kernels, statistics then demap.
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
// plsync_header_kernel: one block of 64 threads per header (lane b, set
// j), at most 48 registers a thread, so that the VCM step's 2,688 headers
// are resident at once (21 blocks an SM). Thread t loads header symbols t
// and t + 64 (any strides) and its frame-metric taps while the header's
// PLS loads, then the conj PLHEADER table row of that PLS (from L2), and
// removes the modulation. Each thread sums its symbols' terms of eight
// sums (the data-aided phase of the 90 symbols and of the last 36, the
// pilot-mode tail, and, when asked, the frame metric's correlations of the
// 89 differentials conj(h[m]) h[m - 1] with the SOF and PLSC taps); one
// transposed butterfly reduces all eight over a warp (9 shuffles), shared
// memory over the two warps, and three lanes finish the two atan2s and max
// |sof +- plsc|. When asked (N > 0), thread t < N / 2 of the first set's
// blocks sums lags t + 1 and N - t - 1 of the autocorrelation r[m - 1] =
// sum_n p[n + m] conj(p[n]) over the first N = 90 or 26 modulation-removed
// symbols, widened to double once into shared memory: N products a thread,
// two accumulators a lag, so no thread runs a chain longer than ~45 steps.
//
// The payload, from the symbol buffer in place (per-lane start clamped
// into [0, rows - clamp_len] as the step's window gather clamps it, any
// strides), descrambled. A lane's SNR sets the scale of all its LLRs, so
// its statistics are complete before any int8 value exists; the payload
// runs as two launches split at that dependency, with a scratch buffer the
// wrapper keeps between them. Both instantiate their symbol loops for each
// pilot mode and load form (one float2 load a symbol where the components
// are adjacent and aligned), so that no loop carries the other's index
// arithmetic.
//
// plsync_stats_kernel: grid (lanes, K chunks of `chunk` data symbols; the
// wrapper takes K = 10, so that the CCM step's 1,280 blocks make two full
// waves at 5 blocks an SM), 256 threads, a template on the constellation.
// Lanes outside the mask (sel) exit. Each block takes its lane's
// pilot-block phases (pilot mode; warps sum the 36 pilots of each block,
// every load first) and the fine CFO (pilot mode from the header tail phase
// and the pilot phases, pilotless from the two header phases), gated by
// coarse_corrected; derotates its chunk and sums the data-aided SNR terms
// in double (QPSK: the sliced energy by counts of its three values;
// otherwise against the nearest constellation point, tied points sharing
// their energies equally), and writes the block's two sums to the scratch
// at (lane, chunk). Chunk 0's block also writes the lane's fine CFO, 2 pi x
// the gated one, and the pilot phases.
//
// plsync_demap_kernel: grid (tiles of 32 lanes, tiles of 256 data symbols,
// 128 at 4-5 bits a symbol), 256 threads, a template on the constellation.
// All threads load the tile's lanes' K partial sums into shared memory;
// the first warp reduces each lane's in chunk order, in double, rounds once
// and takes n0 and n0_use = n0_override if > 0 else n0 (the symbol tile 0
// block writes fine and N0 out), and ranks the selected lanes. A tile with
// no selected lane exits. Warp w then derotates and demaps the tile's
// selected lanes w, w + 8, ... in rank order (a thinly masked tile still
// spreads over every warp), 32 consecutive symbols of a lane a step (each
// warp load reads 256 contiguous bytes of the lane's buffer), QPSK and
// 8PSK in closed form, 16/32APSK max-log over the points; rounds half to
// even, clips to int8, and stages the values in shared memory at their
// deinterleaved positions (bit j of symbol i at column order_j of R rows;
// QPSK 2 i + j): n_mod runs of the tile's positions (QPSK one run of
// twice them), a row of 32 lanes each (rows of 36 bytes: 4-byte aligned,
// no bank conflicts either way). It writes the corrected symbols only for
// the lanes a caller reads (every x_every-th lane, the first x_len
// symbols, times x_scale). Then the write-out runs along whichever LLR
// stride is 1: for the lane-major (N, B) view one warp store is 32 lanes'
// bytes of one position, a whole sector (a whole tile on 4-byte
// boundaries: 4 lanes a thread, 4 sectors a warp store); otherwise (VCM's
// (B, n_ldpc) rows, or any other strides) consecutive threads take
// consecutive positions of one lane. Unselected lanes write nothing. No
// float LLR leaves the kernel.
//
// Numerics. Element-wise products and sums round as the plain version's
// separate launches do (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __frcp_rn:
// no FMA contraction), including PyTorch's forms on the card: a Python
// scalar divided by a tensor is a reciprocal times the scalar, a tensor
// divided by a Python scalar a product with the scalar's reciprocal (the
// wrapper passes those constants). Sums of many terms run in double and
// round once, in a fixed order (no atomics: a replay gives the same
// bytes), so they sit within an ulp or two of torch's float32 sums in
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
// bytes, ~0.5 us, and a launch; the design keeps one wave and a short
// latency chain, and its lags read shared memory (~4 cycles a warp's
// product: ~3 us an SM at the VCM shape). Payload, at the CCM shape (B =
// 128 lanes of 32,400 QPSK symbols): the payload once (33.2 MB), the int8
// LLRs (8.29 MB) and frame 0's corrected symbols (16.6 MB) ~ 58 MB ~
// 0.017 ms at 3.35 TB/s. Both kernels issue ~70-75 instructions a symbol
// (the derotation's sin and cos alone ~30), ~9 us each at the SMs' full
// issue rate; the statistics kernel reads the payload from HBM, the demap
// kernel reads it again, mostly from the 50 MB L2, and writes whole
// sectors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHdrThreads = 64;
constexpr int kHdrMinBlocks = 21;      // 2,688 headers on 132 SMs at once
constexpr int kHdr = 90;               // PLHEADER symbols
constexpr int kTaps = 89;              // frame-metric differentials
constexpr int kTail = 36;              // the pilot-mode tail phase's symbols
constexpr int kPayThreads = 256;       // both payload kernels
constexpr int kPayWarps = kPayThreads / 32;
constexpr int kTileLanes = 32;         // demap: lanes a block
// demap: data symbols a block, by bits per symbol (the stage holds n_mod
// bytes a symbol and lane)
__host__ __device__ constexpr int demap_tile_syms(int n_mod) {
  return n_mod <= 3 ? 256 : 128;
}
constexpr int kStageRow = kTileLanes + 4;  // 4-byte rows, no bank conflicts
constexpr int kMaxChunks = 16;         // statistics chunks a lane, at most
constexpr int kPilotPeriod = 1476;     // pilot block period, symbols
constexpr int kPilotLen = 36;
constexpr int kSegLen = 1440;          // data symbols between pilot blocks
constexpr int kMaxPilots = 22;
constexpr int kLaneFloats = 2 + kMaxPilots;  // scratch a lane: fine, w, pilots
enum Kind { kQPSK = 0, k8PSK = 1, kAPSK = 2 };
// the payload kernels' float constants (plsync_cuda.payload_constants)
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
__device__ __forceinline__ float wrap_rn(float x, float pi, float two_pi) {
  if (x > pi) x = __fsub_rn(x, two_pi);
  if (x < -pi) x = __fadd_rn(x, two_pi);
  return x;
}

// The conversion instructions (F2I, I2F, FRND) issue at a sixteenth of the
// float32 rate, so the per-symbol roundings and int -> float steps use the
// float magic number 1.5 x 2^23 instead: x + M rounds x to the nearest
// integer, ties to even (as rintf), for |x| < 2^22, and the sum's low
// mantissa bits are that integer.
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// rintf(x) for |x| < 2^22, and *i the same as an int
__device__ __forceinline__ float round_magic(float x, int* i) {
  const float m = __fadd_rn(x, kMagic);
  *i = __float_as_int(m) - kMagicBits;
  return __fsub_rn(m, kMagic);
}

// (float)n for 0 <= n < 2^22, exactly
__device__ __forceinline__ float int_to_float(int n) {
  return __fsub_rn(__int_as_float(kMagicBits + n), kMagic);
}

// sin and cos of a, |a| < 1e5: three-part Cody-Waite reduction by pi/2
// with FMA, then minimax polynomials on [-pi/4, pi/4] (Cephes sinf/cosf
// coefficients); within 2 ulp of the true values, no local memory.
__device__ __forceinline__ void sincos_bounded(float a, float* s, float* c) {
  int i;
  const float q = round_magic(__fmul_rn(a, 0.636619772f), &i);
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

// a symbol's two components at p and p + sc: one 8-byte load where they
// are adjacent and aligned (the symbol buffers' usual layout)
__device__ __forceinline__ float2 load2(const float* p, long long sc) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(p) & 7) == 0)
    return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), __ldg(p + sc));
}

__device__ __forceinline__ int8_t quantize_rn(float v) {
  // torch.round (half to even), clamp(-128, 127), to int8: the clamp
  // first (its bounds are integers, so the order makes no difference),
  // then the magic round, whose low byte is the int8 in two's complement
  const float c = fminf(fmaxf(v, -128.0f), 127.0f);
  return (int8_t)(__float_as_int(__fadd_rn(c, kMagic)) & 0xff);
}

// ---------------------------------------------------------------------------
// PLHEADER kernel
// ---------------------------------------------------------------------------

// r[m - 1] = sum_n p[n + m] conj(p[n]), n < N - m, in two accumulators
// (even and odd n), from the float symbols widened to double once (pd);
// float products are exact in double, so only the sums round (once, at
// the end, to float)
__device__ __forceinline__ float2 lag_sum(const double2* pd, int m, int N) {
  double r0 = 0.0, i0 = 0.0, r1 = 0.0, i1 = 0.0;
  int n = 0;
  for (; n + 1 + m < N; n += 2) {
    const double2 a = pd[n + m], c = pd[n];
    const double2 a1 = pd[n + 1 + m], c1 = pd[n + 1];
    r0 = fma(a.x, c.x, fma(a.y, c.y, r0));
    i0 = fma(a.y, c.x, fma(-a.x, c.y, i0));
    r1 = fma(a1.x, c1.x, fma(a1.y, c1.y, r1));
    i1 = fma(a1.y, c1.x, fma(-a1.x, c1.y, i1));
  }
  if (n + m < N) {
    const double2 a = pd[n + m], c = pd[n];
    r0 = fma(a.x, c.x, fma(a.y, c.y, r0));
    i0 = fma(a.y, c.x, fma(-a.x, c.y, i0));
  }
  return make_float2((float)(r0 + r1), (float)(i0 + i1));
}

__global__ void __launch_bounds__(kHdrThreads, kHdrMinBlocks)
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
  __shared__ double2 pd[kHdr];         // p in double, for the lags
  __shared__ double red[8];
  __shared__ double tot[8];
  const int b = blockIdx.x, j = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, ln = t % 32;
  const float* base = (j == 0 ? hdr0 : hdr1) +
                      (long long)(b / Y) * sx + (long long)(b % Y) * sy;
  // the PLS and the header symbols load together; the table row waits for
  // the PLS only
  const long long pls = __ldg((j == 0 ? pls0 : pls1) +
                              (long long)b * pls_stride);
  const int n1 = t + kHdrThreads;
  const bool two = n1 < kHdr;
  const float2 v0 = load2(base + t * sn, sc);
  const float2 v1 = two ? load2(base + n1 * sn, sc) : make_float2(0.f, 0.f);
  // the frame metric's SOF and PLSC taps of this thread's differentials
  const bool tap0 = metric != nullptr && t >= 1;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 ts0 = tap0 ? __ldg(taps + t - 1) : zero;
  const float2 tp0 = tap0 ? __ldg(taps + kTaps + t - 1) : zero;
  const float2 ts1 = metric != nullptr && two ? __ldg(taps + n1 - 1) : zero;
  const float2 tp1 =
      metric != nullptr && two ? __ldg(taps + kTaps + n1 - 1) : zero;
  const float2* row = lut + pls * kHdr;
  const float2 p0 = cmul_rn(v0, __ldg(row + t));
  h[t] = v0;
  p[t] = p0;
  pd[t] = make_double2(p0.x, p0.y);
  if (two) {
    const float2 p1 = cmul_rn(v1, __ldg(row + n1));
    h[n1] = v1;
    p[n1] = p1;
    pd[n1] = make_double2(p1.x, p1.y);
  }
  __syncthreads();
  // this thread's terms of the eight sums: phase (re, im), tail phase,
  // SOF and PLSC correlations of the differentials
  double v[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int n = s == 0 ? t : n1;
    if (s == 1 && !two) break;
    const float2 q = p[n];
    v[0] += q.x;
    v[1] += q.y;
    if (n >= kHdr - kTail) {
      v[2] += q.x;
      v[3] += q.y;
    }
    if (metric != nullptr && n >= 1) {
      // d = conj(h[n]) h[n - 1] (plsync.differentials), then d x taps
      const float2 a = h[n], c = h[n - 1];
      const float2 d = make_float2(
          __fadd_rn(__fmul_rn(a.x, c.x), __fmul_rn(a.y, c.y)),
          __fsub_rn(__fmul_rn(a.x, c.y), __fmul_rn(a.y, c.x)));
      const float2 us = cmul_rn(d, s == 0 ? ts0 : ts1);
      const float2 up = cmul_rn(d, s == 0 ? tp0 : tp1);
      v[4] += us.x;
      v[5] += us.y;
      v[6] += up.x;
      v[7] += up.y;
    }
  }
  // one transposed butterfly over the warp: after the offset-16, -8 and -4
  // steps lane l holds one sum, idx = 4 (l >> 4 & 1) + 2 (l >> 3 & 1) +
  // (l >> 2 & 1), then offsets 2 and 1 finish it
  const unsigned full = 0xffffffffu;
  {
    const bool hi = ln & 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double send = hi ? v[k] : v[k + 4];
      const double keep = hi ? v[k + 4] : v[k];
      v[k] = keep + __shfl_xor_sync(full, send, 16);
    }
  }
  {
    const bool hi = ln & 8;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const double send = hi ? v[k] : v[k + 2];
      const double keep = hi ? v[k + 2] : v[k];
      v[k] = keep + __shfl_xor_sync(full, send, 8);
    }
  }
  {
    const bool hi = ln & 4;
    const double send = hi ? v[0] : v[1];
    const double keep = hi ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(full, send, 4);
  }
  v[0] += __shfl_xor_sync(full, v[0], 2);
  v[0] += __shfl_xor_sync(full, v[0], 1);
  const int idx = ((ln >> 4) & 1) * 4 + ((ln >> 3) & 1) * 2 + ((ln >> 2) & 1);
  if (warp == 1 && (ln & 3) == 0) red[idx] = v[0];
  __syncthreads();
  const int hj = b * J + j;
  if (warp == 0) {
    if ((ln & 3) == 0) tot[idx] = v[0] + red[idx];
    __syncwarp();
    if (ln == 0) {
      phase[2 * hj] = phase_of(tot[0], tot[1]);
    } else if (ln == 1) {
      phase[2 * hj + 1] = phase_of(tot[2], tot[3]);
    } else if (ln == 2 && metric != nullptr) {
      const float s0 = (float)tot[4], s1 = (float)tot[5];
      const float q0 = (float)tot[6], q1 = (float)tot[7];
      const float pr = __fadd_rn(s0, q0), pi = __fadd_rn(s1, q1);
      const float mr = __fsub_rn(s0, q0), mi = __fsub_rn(s1, q1);
      const float e1 = __fadd_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi));
      const float e2 = __fadd_rn(__fmul_rn(mr, mr), __fmul_rn(mi, mi));
      metric[hj] = fmaxf(__fsqrt_rn(e1), __fsqrt_rn(e2));
    }
  }
  if (j == 0 && 2 * t < n_auto) {
    // lags m and N - m: N products in all, whatever m
    const int m = t + 1;
    float2* out = autocorr + (long long)b * (n_auto - 1);
    out[m - 1] = lag_sum(pd, m, n_auto);
    if (n_auto - m != m) out[n_auto - m - 1] = lag_sum(pd, n_auto - m, n_auto);
  }
}

// ---------------------------------------------------------------------------
// Payload kernels
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
  double* part;                  // scratch: (B, n_chunks, 2) SNR sums
  float* lanef;                  // scratch: (B, kLaneFloats)
  long long sx, sy, sn, sc, rows, l_pos, l_lane;
  int B, Y, clamp_len, Lp, n_pilots, R, order, x_every, x_len, n0_use_out;
  int chunk, n_chunks, lane_fastest;
  int vec;                       // every symbol's components adjacent and
                                 // 8-byte aligned: one float2 load each
  float x_scale;
};

// lane b's payload: its buffer view at its clamped start
__device__ __forceinline__ const float* lane_base(const PayloadArgs& a,
                                                  int b) {
  long long s = a.start != nullptr ? __ldg(&a.start[b]) : 0;
  s = max(0LL, min(s, a.rows - a.clamp_len));
  return a.sym + (long long)(b / a.Y) * a.sx + (long long)(b % a.Y) * a.sy +
         s * a.sn;
}

// data symbol i of a lane, loaded: the received symbol, its descrambling
// value, and its derotation phase's start (the header's or its pilot
// block's) and index n. The loops that take it are instantiated for each
// load form and pilot mode, so that none carries the other's index
// arithmetic: kVec, the symbol is one float2 (a.vec); kPilots, a.n_pilots
// > 0.
struct SymIn {
  float2 y, d;
  float phase;
  int n;
};

template <bool kVec, bool kPilots>
__device__ __forceinline__ SymIn load_symbol(const PayloadArgs& a,
                                             const float* lane, int i,
                                             float phase0,
                                             const float* pil_ph) {
  SymIn in;
  int q = i;
  in.n = i;
  in.phase = phase0;
  if (kPilots) {
    const int seg = min(i / kSegLen, a.n_pilots);
    in.n = i - seg * kSegLen;
    q = seg * kPilotPeriod + in.n;
    if (seg > 0) in.phase = pil_ph[seg - 1];
  }
  const float* yp = lane + (long long)q * a.sn;
  in.y = kVec ? __ldg(reinterpret_cast<const float2*>(yp))
              : make_float2(__ldg(yp), __ldg(yp + a.sc));
  in.d = __ldg(&a.descr[q]);
  return in;
}

// the corrected (descrambled, derotated) symbol: y d cexp(-(phase + w n))
__device__ __forceinline__ float2 derotate(const SymIn& in, float w) {
  const float2 yd = cmul_rn(in.y, in.d);
  // ph = phase + (2 pi f) n, then cexp(-ph)
  const float ph = __fadd_rn(in.phase, __fmul_rn(w, int_to_float(in.n)));
  float s, c;
  sincos_bounded(-ph, &s, &c);
  return cmul_rn(yd, make_float2(c, s));
}

// the pilot-block phases of a lane (atan2 of the 36 descrambled pilots,
// less pi/4) into pil_ph, and the lane's fine CFO from the header tail
// phase (pilot mode) or the two header phases (pilotless): every thread
// returns it. The block's threads all call this.
__device__ __forceinline__ float lane_fine(const PayloadArgs& a,
                                           const float* lane, float* pil_ph,
                                           float* steps, float ph_own,
                                           float ph_tail, float ph_next,
                                           float pi, float two_pi, float pi4,
                                           float inv_fine) {
  const int t = threadIdx.x, warp = t / 32, ln = t % 32;
  if (a.n_pilots == 0)
    return __fmul_rn(wrap_rn(__fsub_rn(ph_next, ph_own), pi, two_pi),
                     inv_fine);
  // up to three pilot blocks a warp: every load first, then the sums
  constexpr int kPerWarp = (kMaxPilots + kPayWarps - 1) / kPayWarps;
  float2 v[kPerWarp][2];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int p = warp + u * kPayWarps;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ln + 32 * h;
      v[u][h] = make_float2(0.0f, 0.0f);
      if (p < a.n_pilots && m < kPilotLen) {
        const int q = (p + 1) * kPilotPeriod - kPilotLen + m;
        v[u][h] = cmul_rn(load2(lane + (long long)q * a.sn, a.sc),
                          __ldg(&a.descr[q]));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int p = warp + u * kPayWarps;
    if (p < a.n_pilots) {
      const double pr = warp_sum((double)v[u][0].x + (double)v[u][1].x);
      const double pim = warp_sum((double)v[u][0].y + (double)v[u][1].y);
      if (ln == 0)
        pil_ph[p] = wrap_rn(__fsub_rn(phase_of(pr, pim), pi4), pi, two_pi);
    }
  }
  __syncthreads();
  // fine_foffset_pilot_mode: the wrapped steps from the header tail,
  // summed in order
  if (t < a.n_pilots)
    steps[t] = wrap_rn(__fsub_rn(pil_ph[t], t == 0 ? ph_tail
                                                   : pil_ph[t - 1]),
                       pi, two_pi);
  __syncthreads();
  float acc = steps[0];
  for (int p = 1; p < a.n_pilots; ++p) acc = __fadd_rn(acc, steps[p]);
  return __fmul_rn(acc, inv_fine);
}

// the data-aided SNR terms of a lane's symbols i0, i0 + kPayThreads, ...
// < end, added to *sp and *np in double (QPSK sliced; otherwise against the
// nearest constellation point, tied points sharing their energies equally)
template <int kKind, int kP, bool kVec, bool kPilots>
__device__ __forceinline__ void snr_terms(
    const PayloadArgs& a, const float* lane, int i0, int end, float ph_own,
    const float* pil_ph, float w, float s2, const float2* pts,
    const float* energy, double* sp_out, double* np_out) {
  // symbols in flight per thread (the points' distances take kP
  // registers each)
  // symbols in flight per thread (the points' distances take kP
  // registers each)
  constexpr int kUnroll = kP <= 8 ? 8 : 1;
  double sp = 0.0, np = 0.0;
  // QPSK: a symbol's sliced energy rr^2 + ri^2 is one of three float
  // values (as many components nonzero), so counts of each, times the
  // value, give the double sum exactly
  int c1 = 0, c2 = 0;
#pragma unroll (kUnroll)
  for (int i = i0; i < end; i += kPayThreads) {
    const float2 x = derotate(
        load_symbol<kVec, kPilots>(a, lane, i, ph_own, pil_ph), w);
    if (kKind == kQPSK) {
      const float rr = x.x > 0.0f ? s2 : (x.x < 0.0f ? -s2 : 0.0f);
      const float ri = x.y > 0.0f ? s2 : (x.y < 0.0f ? -s2 : 0.0f);
      const int nz = (rr != 0.0f) + (ri != 0.0f);
      c1 += nz == 1;
      c2 += nz == 2;
      const float er = __fsub_rn(x.x, rr), ei = __fsub_rn(x.y, ri);
      np += __fadd_rn(__fmul_rn(er, er), __fmul_rn(ei, ei));
    } else {
      float d2[kP];
      float dmin = INFINITY;
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        const float dr = __fsub_rn(x.x, pts[q].x);
        const float di = __fsub_rn(x.y, pts[q].y);
        d2[q] = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
        dmin = fminf(dmin, d2[q]);
      }
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < kP; ++q) cnt += d2[q] == dmin;
      // tied points share their energies: sum_q (1 / cnt) e_q
      const float inv = __fdiv_rn(1.0f, (float)max(cnt, 1));
      float e = 0.0f;
#pragma unroll
      for (int q = 0; q < kP; ++q)
        if (d2[q] == dmin) e = __fadd_rn(e, __fmul_rn(inv, energy[q]));
      sp += e;
      np += dmin;
    }
  }
  if (kKind == kQPSK) {
    const float e1 = __fmul_rn(s2, s2);
    sp = (double)c1 * e1 + (double)c2 * __fadd_rn(e1, e1);
  }
  *sp_out = sp;
  *np_out = np;
}

template <int kKind, int kP>
__global__ void __launch_bounds__(kPayThreads)
plsync_stats_kernel(PayloadArgs a) {
  __shared__ float pil_ph[kMaxPilots];
  __shared__ float steps[kMaxPilots];
  __shared__ float2 pts[kP];
  __shared__ float energy[kP];
  __shared__ double red[2][kPayWarps];
  const int b = blockIdx.x, k = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, ln = t % 32;
  // the lane's start loads beside its mask bit, not after it
  const float* lane = lane_base(a, b);
  if (a.sel != nullptr && !a.sel[b]) return;
  // the constants in registers (a store through a char pointer could
  // otherwise alias them)
  const float pi = a.kc[kPi], two_pi = a.kc[kTwoPi], s2 = a.kc[kSqrt2_2];
  if (kKind != kQPSK && t < kP) {
    const float2 v = a.pts[t];
    pts[t] = v;
    energy[t] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  }
  const float ph_own = a.ph[4 * b];
  const float fine = lane_fine(a, lane, pil_ph, steps, ph_own, a.ph[4 * b + 1],
                               a.ph[4 * b + 2], pi, two_pi, a.kc[kPi4],
                               a.kc[kInvFine]);
  const float w = __fmul_rn(two_pi, a.cc[b] ? fine : 0.0f);
  if (k == 0) {
    float* lf = a.lanef + (long long)b * kLaneFloats;
    if (t == 0) {
      lf[0] = fine;
      lf[1] = w;
    }
    if (t < a.n_pilots) lf[2 + t] = pil_ph[t];
  }
  if (kKind != kQPSK) __syncthreads();

  // this chunk's data-aided SNR terms
  double sp = 0.0, np = 0.0;
  const int i0 = k * a.chunk + t, end = min(a.R, (k + 1) * a.chunk);
  if (a.vec && a.n_pilots == 0)
    snr_terms<kKind, kP, true, false>(a, lane, i0, end, ph_own, pil_ph, w, s2,
                                      pts, energy, &sp, &np);
  else if (a.vec)
    snr_terms<kKind, kP, true, true>(a, lane, i0, end, ph_own, pil_ph, w, s2,
                                     pts, energy, &sp, &np);
  else if (a.n_pilots == 0)
    snr_terms<kKind, kP, false, false>(a, lane, i0, end, ph_own, pil_ph, w,
                                       s2, pts, energy, &sp, &np);
  else
    snr_terms<kKind, kP, false, true>(a, lane, i0, end, ph_own, pil_ph, w, s2,
                                      pts, energy, &sp, &np);
  sp = warp_sum(sp);
  np = warp_sum(np);
  if (ln == 0) {
    red[0][warp] = sp;
    red[1][warp] = np;
  }
  __syncthreads();
  if (t == 0) {
    double tsp = 0.0, tnp = 0.0;
    for (int q = 0; q < kPayWarps; ++q) {
      tsp += red[0][q];
      tnp += red[1][q];
    }
    double* out = a.part + ((long long)b * a.n_chunks + k) * 2;
    out[0] = tsp;
    out[1] = tnp;
  }
}

// the demap tile's shared lane values
struct TileLanes {
  float pil[kTileLanes][kMaxPilots];
  float ph0[kTileLanes], w[kTileLanes], n0u[kTileLanes], scale[kTileLanes];
  long long off[kTileLanes];           // lane base, floats from a.sym
  long long xoff[kTileLanes];          // the lane's x_out row, float2s; -1
  int on[kTileLanes];
  int rows[kTileLanes];                // the selected lanes, in order
};

// derotate, demap and quantize a tile's selected lanes into the stage:
// warp w takes lanes w, w + kPayWarps, ..., 32 consecutive symbols a step
template <int kKind, int kP, bool kVec, bool kPilots>
__device__ __forceinline__ void demap_tile(const PayloadArgs& a,
                                           const TileLanes& tl,
                                           const float2* pts, int8_t* stage,
                                           int i0, int ns, int n_on) {
  constexpr int kMod = kKind == kQPSK ? 2 : (kKind == k8PSK ? 3
                                              : (kP == 16 ? 4 : 5));
  constexpr int kUnroll = kP <= 4 ? 4 : (kP <= 8 ? 2 : 1);
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const float x_scale = a.x_scale;
  const float rot_r = a.kc[kRotR], rot_i = a.kc[kRotI];
  const float s2 = a.kc[kSqrt2_2];
  // stage row of (symbol q of the tile, bit j): column runs of ns rows,
  // or one run of kMod ns positions where the bits are not interleaved
  const bool inter = a.order >= 0;
  // the k-th selected lane to warp k mod 8: a thinly selected tile (VCM's
  // per-PLS masks) still spreads its lanes over every warp
  for (int k = warp; k < n_on; k += kPayWarps) {
    const int r = tl.rows[k];
    const float* lane = a.sym + tl.off[r];
    const float* pil = tl.pil[r];
    const float ph0 = tl.ph0[r], w = tl.w[r], n0u = tl.n0u[r];
    const float scale = tl.scale[r];
    const long long xoff = tl.xoff[r];
    float2* xo = xoff >= 0 ? a.x_out + xoff : nullptr;
    const int x_end = xoff >= 0 ? min(ns, a.x_len - i0) : 0;
    int8_t* srow = stage + r;
#pragma unroll (kUnroll)
    for (int q = ln; q < ns; q += 32) {
      const int i = i0 + q;
      const float2 x = derotate(
          load_symbol<kVec, kPilots>(a, lane, i, ph0, pil), w);
      if (q < x_end)
        xo[i] = make_float2(__fmul_rn(x.x, x_scale), __fmul_rn(x.y, x_scale));
      float v[kMod];
      if (kKind == kQPSK) {
        v[0] = __fmul_rn(x.x, scale);
        v[1] = __fmul_rn(x.y, scale);
      } else if (kKind == k8PSK) {
        const float cr = __fsub_rn(__fmul_rn(x.x, rot_r),
                                   __fmul_rn(x.y, rot_i));
        const float ci = __fadd_rn(__fmul_rn(x.x, rot_i),
                                   __fmul_rn(x.y, rot_r));
        const float c0 = __fmul_rn(s2, __fsub_rn(fabsf(cr), fabsf(ci)));
        v[0] = __fmul_rn(c0, scale);
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
        const int ro = inter ? j * ns + q : q * kMod + j;
        srow[ro * kStageRow] = quantize_rn(v[j]);
      }
    }
  }
}

template <int kKind, int kP>
__global__ void __launch_bounds__(kPayThreads)
plsync_demap_kernel(PayloadArgs a) {
  // bits per symbol
  constexpr int kMod = kKind == kQPSK ? 2 : (kKind == k8PSK ? 3
                                              : (kP == 16 ? 4 : 5));
  constexpr int kTS = demap_tile_syms(kMod);
  __shared__ __align__(16) int8_t stage[kMod * kTS * kStageRow];
  __shared__ float2 pts[kP];
  __shared__ TileLanes tl;
  __shared__ double2 parts[kTileLanes][kMaxChunks];
  const int b0 = blockIdx.x * kTileLanes, i0 = blockIdx.y * kTS;
  const int t = threadIdx.x, warp = t / 32, ln = t % 32;
  const int ns = min(kTS, a.R - i0);
  // the tile's lanes' pilot phases (the statistics kernel's), all threads
  for (int e = t; e < kTileLanes * a.n_pilots; e += kPayThreads) {
    const int r = e / a.n_pilots, p = e - r * a.n_pilots;
    if (b0 + r < a.B)
      tl.pil[r][p] = __ldg(&a.lanef[(long long)(b0 + r) * kLaneFloats + 2 + p]);
  }
  if (kKind == kAPSK && t < kP) pts[t] = a.pts[t];
  // the tile's lanes' chunk sums: thread (r, g) loads chunks g, g + 8
  {
    const int r = t % kTileLanes;
    if (b0 + r < a.B) {
      const double2* part = reinterpret_cast<const double2*>(a.part) +
                            (long long)(b0 + r) * a.n_chunks;
      for (int k = t / kTileLanes; k < a.n_chunks; k += kPayWarps)
        parts[r][k] = __ldg(part + k);
    }
  }
  int on = 0;
  float fine = 0.0f, n0_ov = 0.0f;
  if (t < kTileLanes) {
    const int b = b0 + t;
    on = b < a.B && (a.sel == nullptr || a.sel[b]);
    if (on) {
      const float* lf = a.lanef + (long long)b * kLaneFloats;
      fine = __ldg(lf);
      tl.w[t] = __ldg(lf + 1);
      n0_ov = a.n0_ov[b];
      tl.ph0[t] = a.ph[4 * b];
      tl.off[t] = lane_base(a, b) - a.sym;
      tl.xoff[t] = a.x_out != nullptr && b % a.x_every == 0
                       ? (long long)(b / a.x_every) * a.x_len
                       : -1;
    }
  }
  __syncthreads();
  if (on) {
    const int b = b0 + t;
    // the lane's SNR sums, in chunk order
    double tsp = 0.0, tnp = 0.0;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      if (k < a.n_chunks) {
        tsp += parts[t][k].x;
        tnp += parts[t][k].y;
      }
    }
    // snr = sp / max(np, 1e-12); n0 = 1 / max(snr, 1e-9) (a reciprocal)
    const float snr = __fdiv_rn((float)tsp, fmaxf((float)tnp, 1e-12f));
    const float n0 = __frcp_rn(fmaxf(snr, 1e-9f));
    const float n0u = n0_ov > 0.0f ? n0_ov : n0;
    if (blockIdx.y == 0) {
      a.n0_out[b] = a.n0_use_out ? n0u : n0;
      a.fine_out[b] = fine;
    }
    const float rcp = __frcp_rn(n0u);
    // QPSK scale 2 sqrt 2 / n0; 8PSK dist x 4 / n0 (reciprocal x scalar)
    tl.scale[t] = kKind == kQPSK
                      ? __fmul_rn(rcp, a.kc[kQpskNum])
                      : __fmul_rn(__fmul_rn(rcp, 4.0f), a.kc[kDist8]);
    tl.n0u[t] = n0u;
  }
  if (t < kTileLanes) {
    // the selected lanes' ranks: warp 0 holds the tile's lanes
    const unsigned sel = __ballot_sync(0xffffffffu, on);
    if (on) tl.rows[__popc(sel & ((1u << t) - 1u))] = t;
    tl.on[t] = on;
  }
  const int n_on = __syncthreads_count(on);
  if (n_on == 0) return;
  if (a.vec && a.n_pilots == 0)
    demap_tile<kKind, kP, true, false>(a, tl, pts, stage, i0, ns, n_on);
  else if (a.vec)
    demap_tile<kKind, kP, true, true>(a, tl, pts, stage, i0, ns, n_on);
  else if (a.n_pilots == 0)
    demap_tile<kKind, kP, false, false>(a, tl, pts, stage, i0, ns, n_on);
  else
    demap_tile<kKind, kP, false, true>(a, tl, pts, stage, i0, ns, n_on);
  __syncthreads();
  const bool inter = a.order >= 0;

  // write-out, a run at a time: run u starts at position p0 (column
  // order_u of R rows, or the tile's first symbol's first bit), and runs
  // along whichever LLR stride is 1
  const int runs = inter ? kMod : 1;
  const int run_len = inter ? ns : kMod * ns;
  // a whole tile of lane-major LLRs on 4-byte boundaries: a thread stores
  // 4 lanes' bytes, a warp 4 positions' 32-byte sectors an instruction
  const bool words = a.lane_fastest && n_on == kTileLanes &&
                     (reinterpret_cast<uintptr_t>(a.llr + b0) & 3) == 0 &&
                     (a.l_pos & 3) == 0;
  for (int u = 0; u < runs; ++u) {
    const long long p0 =
        inter ? (long long)((a.order >> (4 * u)) & 15) * a.R + i0
              : (long long)i0 * kMod;
    const int8_t* src = stage + u * run_len * kStageRow;
    int8_t* dst = a.llr + p0 * a.l_pos + (long long)b0 * a.l_lane;
    if (words) {
      for (int off = t / 8; off < run_len; off += kPayThreads / 8) {
        const int c = 4 * (t % 8);
        *reinterpret_cast<uint32_t*>(dst + off * a.l_pos + c) =
            *reinterpret_cast<const uint32_t*>(src + off * kStageRow + c);
      }
    } else if (a.lane_fastest) {
      // a warp store is 32 lanes' bytes of one position
      if (tl.on[ln]) {
        for (int off = warp; off < run_len; off += kPayWarps)
          dst[off * a.l_pos + ln * a.l_lane] = src[off * kStageRow + ln];
      }
    } else {
      // a warp store is 32 consecutive positions of one lane
      for (int k = warp; k < n_on; k += kPayWarps) {
        const int r = tl.rows[k];
        for (int off = ln; off < run_len; off += 32)
          dst[off * a.l_pos + r * a.l_lane] = src[off * kStageRow + r];
      }
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

namespace {

// both payload entry points take the same arguments: checks them and
// fills the kernels' argument block; false where the kernels refuse them
bool payload_args(PayloadArgs* a, const void* sym, const void* start,
                  const void* descr, const void* ph, const void* cc,
                  const void* n0_ov, const void* sel, const void* pts,
                  const void* kc, void* llr, void* x_out, void* fine_out,
                  void* n0_out, void* scratch, int B, int Y, long long sx,
                  long long sy, long long sn, long long sc, long long rows,
                  int clamp_len, int Lp, int n_pilots, int R, int n_mod,
                  int order, long long l_pos, long long l_lane, int x_every,
                  int x_len, float x_scale, int n0_use_out, int chunk,
                  int n_chunks, int tile_syms, int lane_fastest) {
  if (B <= 0 || Y <= 0 || R <= 0 || n_pilots < 0 || n_pilots > kMaxPilots ||
      clamp_len < Lp || rows < clamp_len || n_mod < 2 || n_mod > 5 ||
      chunk <= 0 || n_chunks < 1 || n_chunks > kMaxChunks ||
      (long long)chunk * n_chunks < R ||
      (long long)chunk * (n_chunks - 1) >= R ||
      tile_syms != demap_tile_syms(n_mod) ||
      (x_out != nullptr && (x_every <= 0 || x_len <= 0 || x_len > R))) {
    return false;
  }
  a->sym = (const float*)sym;
  a->start = (const long long*)start;
  a->descr = (const float2*)descr;
  a->ph = (const float*)ph;
  a->cc = (const uint8_t*)cc;
  a->n0_ov = (const float*)n0_ov;
  a->sel = (const uint8_t*)sel;
  a->pts = (const float2*)pts;
  a->kc = (const float*)kc;
  a->llr = (int8_t*)llr;
  a->x_out = (float2*)x_out;
  a->fine_out = (float*)fine_out;
  a->n0_out = (float*)n0_out;
  // scratch: the (B, kMaxChunks, 2) double sums, then the lane floats
  a->part = (double*)scratch;
  a->lanef = (float*)((double*)scratch + (long long)B * kMaxChunks * 2);
  a->sx = sx;
  a->sy = sy;
  a->sn = sn;
  a->sc = sc;
  a->rows = rows;
  a->l_pos = l_pos;
  a->l_lane = l_lane;
  a->B = B;
  a->Y = Y;
  a->clamp_len = clamp_len;
  a->Lp = Lp;
  a->n_pilots = n_pilots;
  a->R = R;
  a->order = order;
  a->x_every = x_every;
  a->x_len = x_len;
  a->n0_use_out = n0_use_out;
  a->chunk = chunk;
  a->n_chunks = n_chunks;
  a->lane_fastest = lane_fastest;
  a->vec = sc == 1 && sn % 2 == 0 && sx % 2 == 0 && sy % 2 == 0 &&
           (reinterpret_cast<uintptr_t>(sym) & 7) == 0;
  a->x_scale = x_scale;
  return true;
}

}  // namespace

#define PLSYNC_PAYLOAD_PARAMS                                                 \
  const void *sym, const void *start, const void *descr, const void *ph,      \
      const void *cc, const void *n0_ov, const void *sel, const void *pts,    \
      const void *kc, void *llr, void *x_out, void *fine_out, void *n0_out,   \
      void *scratch, int B, int Y, long long sx, long long sy, long long sn,  \
      long long sc, long long rows, int clamp_len, int Lp, int n_pilots,      \
      int R, int n_mod, int order, long long l_pos, long long l_lane,         \
      int x_every, int x_len, float x_scale, int n0_use_out, int chunk,       \
      int n_chunks, int tile_syms, int lane_fastest, int kind, int n_pts,     \
      void *stream
#define PLSYNC_PAYLOAD_ARGS                                                   \
  &a, sym, start, descr, ph, cc, n0_ov, sel, pts, kc, llr, x_out, fine_out,   \
      n0_out, scratch, B, Y, sx, sy, sn, sc, rows, clamp_len, Lp, n_pilots,   \
      R, n_mod, order, l_pos, l_lane, x_every, x_len, x_scale, n0_use_out,    \
      chunk, n_chunks, tile_syms, lane_fastest

extern "C" int plsync_stats_launch(PLSYNC_PAYLOAD_PARAMS) {
  PayloadArgs a;
  if (!payload_args(PLSYNC_PAYLOAD_ARGS)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, n_chunks);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == kQPSK && n_pts == 4 && n_mod == 2) {
    plsync_stats_kernel<kQPSK, 4><<<grid, kPayThreads, 0, st>>>(a);
  } else if (kind == k8PSK && n_pts == 8 && n_mod == 3) {
    plsync_stats_kernel<k8PSK, 8><<<grid, kPayThreads, 0, st>>>(a);
  } else if (kind == kAPSK && n_pts == 16 && n_mod == 4) {
    plsync_stats_kernel<kAPSK, 16><<<grid, kPayThreads, 0, st>>>(a);
  } else if (kind == kAPSK && n_pts == 32 && n_mod == 5) {
    plsync_stats_kernel<kAPSK, 32><<<grid, kPayThreads, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int plsync_demap_launch(PLSYNC_PAYLOAD_PARAMS) {
  PayloadArgs a;
  if (!payload_args(PLSYNC_PAYLOAD_ARGS)) return (int)cudaErrorInvalidValue;
  const int ts = demap_tile_syms(n_mod);
  const dim3 grid((B + kTileLanes - 1) / kTileLanes, (R + ts - 1) / ts);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == kQPSK && n_pts == 4 && n_mod == 2) {
    plsync_demap_kernel<kQPSK, 4><<<grid, kPayThreads, 0, st>>>(a);
  } else if (kind == k8PSK && n_pts == 8 && n_mod == 3) {
    plsync_demap_kernel<k8PSK, 8><<<grid, kPayThreads, 0, st>>>(a);
  } else if (kind == kAPSK && n_pts == 16 && n_mod == 4) {
    plsync_demap_kernel<kAPSK, 16><<<grid, kPayThreads, 0, st>>>(a);
  } else if (kind == kAPSK && n_pts == 32 && n_mod == 5) {
    plsync_demap_kernel<kAPSK, 32><<<grid, kPayThreads, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
