// Feed-forward (Oerder & Meyr) timing estimate and its alpha-beta tracker,
// one thread block cluster a channel.
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
// kPiece samples. A channel is a thread block cluster of G blocks
// (track_plan: 8 blocks of 2 pieces for 16 windows), block rank r taking
// pieces r per .. r per + per - 1, one group of 128 threads a piece. Each
// group issues its piece's loads at once, with their halo (6 samples
// before, 5 after, zeros outside the window, as the JAX "same"-mode
// convolution pads it; a multi-window piece is its whole window, so only
// its 1,024 samples are read), by 8-byte cp.async into a padded shared
// layout, and starts its sums when its own copies have landed (its own
// named barrier). Each thread computes 8 consecutive samples' O&M terms
// from a register window of 19 samples: the centre tap's |x|^2 c^2 and the
// 12-tap odd branch's |o|^2, o[k] = sum_j x[k + 5 - j] h[j], signed
// (-1)^k, the odd term's index 0 masked. Their sums run in double: a
// warp's over its 256 samples by a shuffle tree, whose lane 0 writes it
// into rank 0's shared memory (distributed shared memory, after a cluster
// barrier that says every block runs). After a second cluster barrier
// (every partial written; the other blocks have left), rank 0 stages the
// subfilter bank where its own pieces were, and warp 0 adds each window's
// warp partials, window by window, piece by piece, warp by warp (no
// atomics, no global scratch: a graph replay writes the same bytes), takes
// each window's atan2 on its own lane and each window's unwrap step beside
// it; lane 0 then runs the unwrap's running sum, the least-squares slope
// (multi) or the single estimate, the innovation and the alpha-beta update
// in float32 in the plain version's order, the end position, the slip and
// `consumed`; lane s each segment's position, whole-sample offset and
// subfilter index (floor(n_subfilt mu)). Rank 0's block then gathers each
// segment's taps from the bank, and writes tau', rate', initialized' = 1,
// taps (C, S, L), offsets (C, S) and consumed (C,).
//
// Numerics: element-wise steps round as the plain version's launches do
// (__fmul_rn, __fadd_rn, __fdiv_rn); the odd branch's 12-tap sums are FMA
// chains and the window sums double sums in another order than torch's
// float32 ones, so tau and the drift sit within ~1e-6 samples of the plain
// version's, and a subfilter index or a slip differs only where the plain
// value sits at a bin edge. The split over a cluster keeps every sum's
// terms and order of the one-block-a-channel design, so its outputs are
// that design's bit for bit.
//
// What bounds it: the windows' bytes, 16,384 samples a channel (8.4 MB at
// C = 64, 2.5 us at 3.35 TB/s); 12 x 2 FMAs a sample; then lane 0's chain
// (the atan2s, the unwrap, the slope, the update, ~1,400 cycles by
// stamps). One block a channel filled 64 of the 132 SMs at C = 64 and one
// at C = 1, staged its pieces in four rounds and ran the unwrap's fmodf
// chain on one lane; a cluster spreads a channel's pieces over up to 8
// SMs with every load in flight at once. At C = 64 the H100 keeps 62
// clusters of 8 resident (cudaOccupancyMaxActiveClusters), so 2 run in a
// second wave; the designs tried that fit one wave (4 blocks a channel,
// with 4 pieces a block or two sums a thread) and 16-byte copies were no
// faster (PERF.md, tools/torch_ffsync_variants.py): the loads are the
// windows' bytes over device memory at C = 64 and their latency at C = 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 128;                  // threads a piece
constexpr int kPer = 8;                      // samples a thread
constexpr int kPiece = kGroup * kPer;        // samples a piece
constexpr int kMaxCluster = 8;               // blocks a channel (portable)
constexpr int kMaxPer = 2;                   // pieces a block
constexpr int kMaxThreads = kGroup * kMaxPer;
constexpr int kMinBlocks = 4;                // blocks an SM: <= 64 registers
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
// a piece's staging bytes, rounded to 16 (16-byte copies of the bank)
constexpr int kPieceBytes = (kSlots * 8 + 15) / 16 * 16;
// the kernel's static shared memory: the warp partials, segment indices
constexpr int kStaticSmem = 16 * kMaxPieces * kWarpsPerGroup + 4 * kMaxSeg;

struct TrackPlan {
  int G, per, threads;     // blocks a channel, pieces a block, threads
};

// The work plan (ops/ffsync_cuda.py plan mirrors it): a channel's pieces
// over up to kMaxCluster blocks (a portable cluster), at most one a piece,
// ceil(pieces / kMaxCluster) a block; then the fewest blocks that take them
// at that many a block (16 windows: 8 blocks of 2, 256 threads each).
TrackPlan track_plan(int n_pieces) {
  const int per = (n_pieces + kMaxCluster - 1) / kMaxCluster;
  return {(n_pieces + per - 1) / per, per, per * kGroup};
}

// dynamic shared memory: the pieces' staging, which rank 0 reuses for the
// subfilter bank once its own sums are done
size_t track_smem_bytes(int per, int bank_floats) {
  const size_t pieces = (size_t)per * kPieceBytes;
  const size_t bank = ((size_t)bank_floats * 4 + 15) / 16 * 16;
  return pieces > bank ? pieces : bank;
}

struct TrackArgs {
  const float2* buf;       // (C, N) pairs
  const int* start;        // (C,) or null
  const float* bank;       // (n_subfilt, L), 16-byte aligned
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
  int G, per, ppw, n_pieces;   // the plan; pieces a window, in all
  float cc, smooth, rate_gain, max_rate, c_sym, two_pi;
  int offs[kMaxWindows];       // window starts in the block
  float wc[kMaxWindows];       // window centres in symbols (multi)
  float hb[kTaps];             // reversed even half-band taps
};

// jnp.mod's float arithmetic (ops/cplx.mod): fmod, then a sign fix
__device__ __forceinline__ float mod_rn(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && ((r < 0.f) != (m < 0.f))) r = __fadd_rn(r, m);
  return r;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the kGroup threads of group g (named barrier 1 + g; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(kGroup) : "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the cluster barrier in two halves: arrive (release: this thread's
// writes to shared memory, its own block's or another's, are done; relaxed:
// no order) and wait (acquire: every thread of the cluster has arrived)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
ffsync_track_kernel(const TrackArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // rank 0's: every piece's warp partials, written by the block that
  // summed it
  __shared__ double2 part[kMaxPieces][kWarpsPerGroup];
  __shared__ int s_idx[kMaxSeg];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();         // this block runs: its partials may go
  const int rank = (int)cluster.block_rank();
  const bool lead = rank == 0;
  const int c = blockIdx.x / a.G;
  const int g = threadIdx.x / kGroup, q = threadIdx.x % kGroup;
  const int p = rank * a.per + g;             // this group's piece
  const bool has = p < a.n_pieces;
  const int w = p / a.ppw, k0 = (p - w * a.ppw) * kPiece;
  float2* win = reinterpret_cast<float2*>(smem + g * kPieceBytes);

  // the piece's samples, 6 before it and 5 after it (zeros outside the
  // window), by the group's threads, all in flight at once
  if (has) {
    const int s0 = a.start ? min(max(__ldg(a.start + c), 0), a.N - a.len)
                           : 0;
    int off = 0;
#pragma unroll
    for (int i = 0; i < kMaxWindows; ++i)
      if (i == w) off = a.offs[i];
    const float2* xw = a.buf + (long long)c * a.N + s0 + off;
    for (int i = q; i < kPiece + kHalo; i += kGroup) {
      const int k = k0 - kLead + i;
      if (k >= 0 && k < a.wlen) cp_async8(win + padded(i), xw + k);
      else win[padded(i)] = make_float2(0.f, 0.f);
    }
  }
  cp_async_commit();
  // the tracker's state, for lane 0 of rank 0
  float tau = 0.f, rate0 = 0.f;
  int init_in = 0;
  if (lead && threadIdx.x == 0) {
    tau = __ldg(a.tau_in + c);
    rate0 = __ldg(a.rate_in + c);
    init_in = __ldg(a.init_in + c);
  }
  double2* to = cluster.map_shared_rank(&part[0][0], 0);

  cp_async_wait_all();              // this thread's copies
  if (has) {
    group_sync(g);                  // the whole piece has landed
    float2 v[kPer + kHalo];
#pragma unroll
    for (int j = 0; j < kPer + kHalo; ++j) v[j] = win[padded(kPer * q + j)];
    double re = 0.0, im = 0.0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = k0 + kPer * q + r;
      if (k < a.wlen) {
        const float2 xs = v[r + kLead];
        float o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          o0 = fmaf(v[r + j].x, a.hb[j], o0);
          o1 = fmaf(v[r + j].y, a.hb[j], o1);
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
    cluster_wait();                 // every block of the cluster runs
    if ((q & 31) == 0)
      to[p * kWarpsPerGroup + (q >> 5)] = make_double2(re, im);
  } else {
    cluster_wait();
  }
  cluster_arrive();                 // this block's partials are in rank 0
  if (!lead) return;

  // rank 0, while the other blocks finish: the subfilter bank into its
  // own pieces' staging (every group's reads are done); lane 0 the window
  // centres' mean and spread (no sample in them), the first half of the
  // plain version's least-squares sums in its order
  float* bank_s = reinterpret_cast<float*>(smem);
  __syncthreads();
  const int nb = a.n_subfilt * a.L;
  for (int i = 4 * threadIdx.x; i < nb; i += 4 * blockDim.x) {
    if (i + 4 <= nb) {
      cp_async16(bank_s + i, a.bank + i);
    } else {
      for (int j = i; j < nb; ++j) cp_async4(bank_s + j, a.bank + j);
    }
  }
  cp_async_commit();
  const int lane = threadIdx.x & 31;
  const float sps = (float)a.sps, half = 0.5f * sps;
  float wbar = 0.f, den = 0.f;
  if (threadIdx.x == 0 && a.multi) {
    float sw = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxWindows; ++i)
      if (i < a.W) sw = __fadd_rn(sw, a.wc[i]);
    wbar = __fdiv_rn(sw, (float)a.W);
#pragma unroll
    for (int i = 0; i < kMaxWindows; ++i) {
      if (i < a.W) {
        const float dw = __fsub_rn(a.wc[i], wbar);
        den = __fadd_rn(den, __fmul_rn(dw, dw));
      }
    }
  }
  cluster_wait();                   // every piece's partials are here

  if (threadIdx.x < 32) {
    // window `lane`: its pieces' warp partials in order, then its estimate
    float tw = 0.f;
    if (lane < a.W) {
      // each piece's partials read while the last piece's are added
      const double2* pw = &part[lane * a.ppw][0];
      double2 cur[kWarpsPerGroup], nxt[kWarpsPerGroup] = {};
#pragma unroll
      for (int u = 0; u < kWarpsPerGroup; ++u) cur[u] = pw[u];
      double re = 0.0, im = 0.0;
      for (int k = 0; k < a.ppw; ++k) {
        if (k + 1 < a.ppw) {
#pragma unroll
          for (int u = 0; u < kWarpsPerGroup; ++u)
            nxt[u] = pw[(k + 1) * kWarpsPerGroup + u];
        }
#pragma unroll
        for (int u = 0; u < kWarpsPerGroup; ++u) {
          re += cur[u].x;
          im += cur[u].y;
          cur[u] = nxt[u];
        }
      }
      // (-atan2(im, re) / (2 pi)) * sps
      const float t = atan2f(__double2float_rn(im), __double2float_rn(re));
      tw = __fmul_rn(__fdiv_rn(-t, a.two_pi), sps);
    }
    // window `lane`'s unwrap step from the one before, beside the others
    const float prev = __shfl_up_sync(0xffffffffu, tw, 1);
    const float d = __fsub_rn(
        mod_rn(__fadd_rn(__fsub_rn(tw, prev), half), sps), half);
    float tau0 = 0.f, rate = 0.f;
    if (a.multi) {
      // the unwrap's running sum, then the least-squares line over the
      // window centres (the loops unrolled to kMaxWindows, so t_un stays
      // in registers)
      float t_un[kMaxWindows];
      t_un[0] = 0.f;
#pragma unroll
      for (int i = 1; i < kMaxWindows; ++i) {
        const float di = __shfl_sync(0xffffffffu, d, i);
        t_un[i] = i < a.W ? __fadd_rn(t_un[i - 1], di) : 0.f;
      }
      if (lane == 0) {
        float st = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxWindows; ++i)
          if (i < a.W) st = __fadd_rn(st, t_un[i]);
        const float tbar = __fdiv_rn(st, (float)a.W);
        float num = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxWindows; ++i) {
          if (i < a.W) {
            const float dw = __fsub_rn(a.wc[i], wbar);
            num = __fadd_rn(num, __fmul_rn(dw, __fsub_rn(t_un[i], tbar)));
          }
        }
        const float slope = __fdiv_rn(num, den);
        const float tau_meas = mod_rn(
            __fsub_rn(__fadd_rn(tw, tbar), __fmul_rn(slope, wbar)), sps);
        const float rate_meas = clampf(slope, -a.max_rate, a.max_rate);
        const float innov = __fsub_rn(
            mod_rn(__fadd_rn(__fsub_rn(tau_meas, tau), half), sps), half);
        const bool init = init_in > 0;
        rate = init ? clampf(
                          __fadd_rn(
                              __fadd_rn(rate0,
                                        __fmul_rn(a.rate_gain,
                                                  __fsub_rn(rate_meas,
                                                            rate0))),
                              __fdiv_rn(__fmul_rn(a.rate_gain, innov),
                                        (float)a.n_out)),
                          -a.max_rate, a.max_rate)
                    : rate_meas;
        tau0 = init ? __fadd_rn(tau, __fmul_rn(a.smooth, innov)) : tau_meas;
      }
    } else if (lane == 0) {
      const float tau_meas = mod_rn(tw, sps);
      const float pred = __fadd_rn(tau, __fmul_rn(rate0, a.c_sym));
      const float innov = __fsub_rn(
          mod_rn(__fadd_rn(__fsub_rn(tau_meas, pred), half), sps), half);
      const bool init = init_in > 0;
      tau0 = init ? __fadd_rn(tau, __fmul_rn(a.smooth, innov)) : tau_meas;
      rate = init ? clampf(__fadd_rn(rate0,
                                     __fdiv_rn(__fmul_rn(a.rate_gain,
                                                         innov),
                                               (float)a.n_out)),
                           -a.max_rate, a.max_rate)
                  : 0.f;
    }
    if (lane == 0) {
      // carry and slips (half-symbol hysteresis deadband [-sps/2, 1.5 sps))
      const float pos_end = __fadd_rn(tau0, __fmul_rn(rate, (float)a.n_out));
      const bool dead = pos_end >= -half && pos_end < 3.f * half;
      const int slip = dead ? 0 : (int)floorf(__fdiv_rn(
                                      __fadd_rn(pos_end, half), sps));
      a.tau_out[c] = __fsub_rn(pos_end, __fmul_rn((float)slip, sps));
      a.rate_out[c] = rate;
      a.init_out[c] = 1;
      a.consumed[c] = a.n_out * a.sps + slip * a.sps;
    }
    tau0 = __shfl_sync(0xffffffffu, tau0, 0);
    rate = __shfl_sync(0xffffffffu, rate, 0);
    // each segment's subfilter phase at its centre and whole-sample offset
    for (int s = lane; s < a.S; s += 32) {
      const float kc = __fmul_rn((float)s + 0.5f, (float)a.seg_len);
      const float ts = __fadd_rn(tau0, __fmul_rn(rate, kc));
      const float fb = floorf(ts);
      const int base = (int)fb;
      const float mu = __fsub_rn(ts, fb);
      const int idx = (int)floorf(__fmul_rn((float)a.n_subfilt, mu));
      s_idx[s] = min(max(idx, 0), a.n_subfilt - 1);
      a.off_out[c * a.S + s] = min(max(base + 2, 0), a.off_bound);
    }
  }
  cp_async_wait_all();              // this thread's bank copies
  __syncthreads();                  // the bank and the subfilter indices
  float* taps = a.taps_out + (long long)c * a.S * a.L;
  for (int i = threadIdx.x; i < a.S * a.L; i += blockDim.x) {
    const int s = i / a.L;
    taps[i] = bank_s[s_idx[s] * a.L + (i - s * a.L)];
  }
}

}  // namespace

extern "C" int ffsync_piece_samples() { return kPiece; }

extern "C" int ffsync_track_plan(int n_pieces) {
  return track_plan(n_pieces).G;
}

extern "C" int ffsync_track_smem_bytes(int per, int bank_floats) {
  return (int)track_smem_bytes(per, bank_floats);
}

// offs (W,) int32, wc (W,) float32 (multi) and hb (12,) float32 are host
// arrays: the window starts and centres and the taps travel in the
// kernel's arguments
extern "C" int ffsync_track_launch(
    const void* buf, const void* start, const void* offs, const void* wc,
    const void* hb, const void* bank, const void* tau_in,
    const void* rate_in, const void* init_in, void* tau_out, void* rate_out,
    void* init_out, void* taps_out, void* off_out, void* consumed, int C,
    int N, int len, int W, int wlen, int multi, int L, int n_subfilt, int S,
    int seg_len, int n_out, int sps, int off_bound, float cc, float smooth,
    float rate_gain, float max_rate, float c_sym, float two_pi,
    void* stream) {
  const int ppw = (wlen + kPiece - 1) / kPiece;
  if (C <= 0 || len < 1 || len > N || W < 1 || W > kMaxWindows ||
      wlen < 1 || wlen > len || (long long)W * ppw > kMaxPieces ||
      !offs || (multi && !wc) || !hb || L < 1 || n_subfilt < 1 || S < 1 ||
      S > kMaxSeg || seg_len < 1 || n_out < 1 || sps < 1 || off_bound < 0 ||
      ((uintptr_t)bank & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  TrackArgs a{(const float2*)buf, (const int*)start, (const float*)bank, (const float*)tau_in,
              (const float*)rate_in, (const int*)init_in, (float*)tau_out,
              (float*)rate_out, (int*)init_out, (float*)taps_out,
              (int*)off_out, (int*)consumed, N, len, W, wlen, multi, L,
              n_subfilt, S, seg_len, n_out, sps, off_bound, 0, 0, ppw,
              W * ppw, cc, smooth, rate_gain, max_rate, c_sym, two_pi, {},
              {}, {}};
  for (int i = 0; i < W; ++i) {
    a.offs[i] = ((const int*)offs)[i];
    a.wc[i] = multi ? ((const float*)wc)[i] : 0.f;
  }
  for (int j = 0; j < kTaps; ++j) a.hb[j] = ((const float*)hb)[j];
  // a refused call returns its error and clears it, so that the next
  // launch's cudaGetLastError does not report it again
  cudaError_t e = cudaSuccess;
  const TrackPlan p = track_plan(W * ppw);
  a.G = p.G;
  a.per = p.per;
  const size_t smem = track_smem_bytes(p.per, n_subfilt * L);
  if (smem + kStaticSmem > 48 * 1024) {
    e = cudaFuncSetAttribute(ffsync_track_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * p.G);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ffsync_track_kernel, a);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
