// The BCH decoder on the card: the locator kernel (hard bits -> syndromes
// S, error locator sigma and its length L) and the Chien search.
//
// Neither replaces a Pallas kernel. They replace the JAX package's
// syndrome product (dvbs2rx_tpu/ops/bch.py:84-94, lane-major :199-207),
// its lax.fori_loop of 2t Berlekamp-Massey rounds (:96-148) and its Chien
// product with the bit-plane matrix T (:150-166) plus the correction masks
// (:179-187), which the port's plain versions (locator_plain, chien_plain
// and correct_plain in ops/bch.py) run as one float32 product with an
// (nbch, 2tm) matrix (49.8 MB for normal 1/2), ~65 small launches per
// round and one float32 product with a ((t+1)m, nbch*m) matrix (431 MB).
// Both kernels give the plain versions' integers bit for bit.
//
// bch_locator_kernel<T>: grid (chunks, frame groups of 32), 8 warps a
// block, one block per SM (the tail's table takes most of its shared
// memory). Lane l of every warp of group g is frame 32g + l. Only the t odd
// syndromes are summed: position e adds alpha^(j p_e), p_e = nbch-1-e, to
// S_j when its bit is set, and the decoder's table of odd powers holds
// those t 16-bit values per position, two to a word. A block stages its
// chunk of positions (the group's 32 bits of each and the table rows, by
// cp.async in two halves, the first summed while the second lands) and
// each warp takes a share in pairs: per pair two bit loads, three 16-byte
// row loads (the same address in every lane: a broadcast) and t
// select-and-XORs, each one LOP3 on two syndromes. The even syndromes
// follow as S_2j = S_j^2 (r has binary coefficients). A block XORs its
// warps' sums in shared memory and folds them into the group's
// accumulators with atomicXor; the block that arrives last (an arrival
// counter per group) takes the sums back with atomicExch, which returns
// the accumulators and the counter to 0 for the next launch (a CUDA-graph
// replay stays right). If every frame of the group is clean it writes S =
// 0, sigma = 1, L = 0. Otherwise it copies the Zech table Z(k) = log(1 +
// alpha^k) into shared memory (128 KB at m = 16, where exp and log could
// not both fit) and runs Berlekamp-Massey in the log domain with 8 lanes a
// frame, all 8 warps: lane r holds the logs of the coefficients r + 8q of
// C and x^m B, a product is a sum of logs and a sum is one Zech lookup
// (log(a + b) = log a + Z(log b - log a)), so the rounds read no other
// table. A round: each lane's terms log C[i] + log S[n-i] (i <= n) summed
// as a tree, the 8 lanes' sums joined by a 3-step butterfly to log d, the
// update C + (d/b) x^m B of each lane's coefficients, and x^m B shifted up
// one coefficient by a shuffle (x C after a length change). A zero's log
// is >= 2^27 and stays so (each wrap takes off at most ord). The update
// rules (update, grow, L, m, b) are the plain loop's, applied to every
// frame over 2t + 1 coefficients, so an uncorrectable frame (L > t) gets
// the same truncated sigma and L. What bounds it: the syndrome stage's
// select-and-XORs and bytes (the bits, 4.15 MB at S2_B4, B = 128), then
// the rounds' dependency chain (about four Zech lookups and three
// shuffles a round).
//
// bch_chien_kernel: one block of 512 threads per frame. A frame that is
// clean (every syndrome 0) or whose locator is too long (L > t) decides its
// count at once and leaves the block. Otherwise the block starts copying
// the (2^m - 1)-entry antilog table into shared memory with cp.async (128
// KB for m = 16), lists the nonzero coefficients of sigma (the same list
// in every thread, so the search loops over them warp-uniformly), and
// computes its exponents in 32-bit arithmetic while the copy is in flight;
// then it evaluates sigma at alpha^(-p_e) for every position e in the log
// domain:
//     sigma(alpha^(-p_e)) = XOR_i exp[(log sigma_i - i p_e) mod (2^m - 1)]
// with no T matrix. Thread k takes the positions k and k + 512, then
// k + 1024 and k + 1536, ..., so each step has two independent chains, and
// every exponent grows by 1024 i (reduced mod 2^m - 1) from one step to
// the next. Roots are counted in shared memory (a degree <= t polynomial
// has at most t of them, each position a distinct point), the block
// synchronises, and only then, when the count equals L, are the roots'
// bits flipped. The wrapper passes a copy of the hard bits with its
// strides (rows of frames, or the lane-major (nbch, B) layout that
// decode_lane_major holds), so the kernel writes at most t bytes per frame
// and never reads the bits. What bounds it: the shared-memory table reads,
// one per nonzero coefficient and position, at 32 per cycle per SM. A
// clean batch costs a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 12;                 // DVB-S2 BCH codes: t = 8, 10, 12
constexpr int kLocWarps = 8;              // warps per locator block
constexpr int kLocThreads = kLocWarps * 32;
constexpr int kStageQuads = 256;          // positions / 4 staged at a time
constexpr int kChienThreads = 512;
constexpr int kChienFill = 16;            // 16-byte table rows per thread
constexpr int kMaxOrd = 65535;            // GF(2^16)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kZeroLog = 1u << 28;   // the log of 0 (valid logs < 2^16)

// x mod ord for x < 2 ord (below ord, x - ord wraps high and min keeps x)
__device__ __forceinline__ unsigned wrap(unsigned x, unsigned ord) {
  return min(x, x - ord);
}

// log(a + b) from log a and log b (a zero's log is any value >= 2^27):
// log lo + Z(log hi - log lo) with lo, hi = min, max and the Zech table
// Z(k) = log(1 + alpha^k), whose entry ord is 0 (a zero term leaves the
// other); equal logs (a = b) sum to zero
__device__ __forceinline__ unsigned gf_add_log(const uint16_t* zt, unsigned la,
                                               unsigned lb, unsigned ord) {
  const unsigned lo = min(la, lb), k = max(la, lb) - lo;
  const unsigned r = wrap(lo + zt[min(k, ord)], ord);
  return k == 0 ? kZeroLog : r;
}

// log of a product: a zero's log stays >= 2^27 (each wrap takes off at
// most ord, and a log passes through fewer than 2^11 of them)
__device__ __forceinline__ unsigned gf_mul_log(unsigned la, unsigned lb,
                                               unsigned ord) {
  return wrap(la + lb, ord);
}

__device__ __forceinline__ unsigned gf_log_g(const uint16_t* lg, unsigned v) {
  const unsigned l = __ldg(lg + v);       // log16[0] = 0xFFFF: log of 0
  return l == 0xFFFFu ? kZeroLog : l;
}

__device__ __forceinline__ unsigned gf_exp_g(const uint16_t* ex, unsigned l,
                                             unsigned ord) {
  return l >= ord ? 0u : __ldg(ex + l);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x mod ord for x < 2^(2m), ord = 2^m - 1 (2^m = 1 mod ord)
__device__ __forceinline__ unsigned fold(unsigned x, unsigned ord, int m) {
  return wrap((x & ord) + (x >> m), ord);
}

// Start staging positions [p0, p1) of the stage at e0 into shared memory
// (one cp.async group): the group's 32 bits of each position (bits_s[p *
// 32 + lane], zero past B) and the table rows (rows_s, KW words each).
// cp.async in 16-byte pieces where the layout allows (lane-major, B a
// multiple of 16), else loads by bytes, positions fastest in the row layout
// and frames fastest otherwise.
template <int KW>
__device__ __forceinline__ void stage_positions(
    uint8_t* bits_s, unsigned* rows_s, const uint8_t* bits, long long sb,
    long long se, const unsigned* odd, int g, int B, int e0, int p0, int p1,
    int vec) {
  const int tid = threadIdx.x;
  const int f0 = g * 32, np = p1 - p0;
  if (vec) {                              // 2 pieces of 16 frames a row
    for (int i = tid; i < 2 * np; i += kLocThreads) {
      const int p = p0 + (i >> 1), f = f0 + (i & 1) * 16;
      const uint8_t* src = bits + (long long)(e0 + p) * se + f;
      cp_async16(bits_s + p * 32 + (i & 1) * 16, f < B ? src : bits,
                 f < B ? 16 : 0);
    }
  } else if (se == 1) {
    for (int i = tid; i < 32 * np; i += kLocThreads) {
      const int f = i / np, p = p0 + i - f * np;
      bits_s[p * 32 + f] =
          f0 + f < B ? __ldg(bits + (long long)(f0 + f) * sb + e0 + p) : 0;
    }
  } else {
    for (int i = tid; i < 32 * np; i += kLocThreads) {
      const int p = p0 + (i >> 5), f = i & 31;
      bits_s[p * 32 + f] =
          f0 + f < B ? __ldg(bits + (long long)(f0 + f) * sb +
                             (long long)(e0 + p) * se)
                     : 0;
    }
  }
  const uint4* src =
      reinterpret_cast<const uint4*>(odd + (long long)(e0 + p0) * KW);
  uint4* dst = reinterpret_cast<uint4*>(rows_s + p0 * KW);
  for (int i = tid; i < np * KW / 4; i += kLocThreads)
    cp_async16(dst + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// XOR the table rows of the set bits of positions [p0, p1) into s, this
// warp's share of them in pairs (two rows are 16-byte aligned, KW even)
template <int KW>
__device__ __forceinline__ void sum_positions(unsigned (&s)[KW],
                                              const uint8_t* bits_s,
                                              const unsigned* rows_s, int p0,
                                              int p1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = (p1 - p0) / 2;
  const int pa = p0 + 2 * (pairs * warp / kLocWarps);
  const int pb = p0 + 2 * (pairs * (warp + 1) / kLocWarps);
#pragma unroll 2
  for (int p = pa; p < pb; p += 2) {
    const unsigned m0 = 0u - (unsigned)(bits_s[p * 32 + lane] & 1);
    const unsigned m1 = 0u - (unsigned)(bits_s[p * 32 + 32 + lane] & 1);
    const uint4* r = reinterpret_cast<const uint4*>(rows_s + p * KW);
    unsigned w[2 * KW];
#pragma unroll
    for (int h = 0; h < KW / 2; ++h) {
      const uint4 v = r[h];
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < KW; ++k) s[k] ^= (w[k] & m0) ^ (w[KW + k] & m1);
  }
}

template <int T>
__global__ void __launch_bounds__(kLocThreads, 1)
bch_locator_kernel(const uint8_t* __restrict__ bits, long long stride_b,
                   long long stride_e, const unsigned* __restrict__ odd,
                   const uint16_t* __restrict__ exp16,
                   const uint16_t* __restrict__ log16,
                   const uint4* __restrict__ zech16,
                   long long* __restrict__ S_out,
                   long long* __restrict__ sigma_out,
                   long long* __restrict__ L_out, unsigned* __restrict__ acc,
                   unsigned* __restrict__ arrivals, int B, int nbch, int ord,
                   int vec) {
  constexpr int KW = (T + 3) / 4 * 2;     // table words per position
  constexpr int W = 2 * T + 1;            // coefficients of C and x^m B
  extern __shared__ uint4 smem[];
  __shared__ int s_last, s_dirty;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.y;
  const int frame = g * 32 + lane;
  const bool live = frame < B;

  // ---- the odd syndromes of the block's quads, staged kStageQuads at a
  // time; warp w takes its share of each stage
  const int quads = nbch >> 2;
  const int q0 = (int)((long long)blockIdx.x * quads / gridDim.x);
  const int q1 = (int)((long long)(blockIdx.x + 1) * quads / gridDim.x);
  uint8_t* bits_s = reinterpret_cast<uint8_t*>(smem);
  unsigned* rows_s = reinterpret_cast<unsigned*>(smem + kStageQuads * 4 * 2);
  unsigned s[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) s[k] = 0;
  for (int qs = q0; qs < q1; qs += kStageQuads) {
    // two halves in flight; the first is summed while the second lands
    const int np = 4 * min(kStageQuads, q1 - qs);
    const int half = 4 * ((np / 4 + 1) / 2);
    stage_positions<KW>(bits_s, rows_s, bits, stride_b, stride_e, odd, g, B,
                        4 * qs, 0, half, vec);
    stage_positions<KW>(bits_s, rows_s, bits, stride_b, stride_e, odd, g, B,
                        4 * qs, half, np, vec);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    sum_positions<KW>(s, bits_s, rows_s, 0, half);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    sum_positions<KW>(s, bits_s, rows_s, half, np);
    __syncthreads();
  }

  // ---- the block's sum into the group's accumulators; the last block on
  unsigned* red = reinterpret_cast<unsigned*>(smem);   // [warp][KW][32]
#pragma unroll
  for (int k = 0; k < KW; ++k) red[(warp * KW + k) * 32 + lane] = s[k];
  __syncthreads();
  for (int i = tid; i < KW * 32; i += kLocThreads) {
    unsigned v = 0;
#pragma unroll
    for (int w = 0; w < kLocWarps; ++w) v ^= red[w * KW * 32 + i];
    if (v) atomicXor(&acc[((long long)g * 32 + (i & 31)) * KW + (i >> 5)], v);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&arrivals[g], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  unsigned sw[KW];
  if (warp == 0) {
    bool dirty = false;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      sw[k] = atomicExch(&acc[(long long)frame * KW + k], 0u);
      dirty |= sw[k] != 0;
    }
    const bool any = __any_sync(kFull, dirty);
    if (lane == 0) {
      s_dirty = any;
      arrivals[g] = 0;
    }
  }
  __syncthreads();
  const int rows = (ord + 1) >> 3;        // 16-byte rows of the Zech table
  const bool dirty = s_dirty;
  if (dirty) {
    for (int i = tid; i < rows; i += kLocThreads)
      cp_async16(smem + i, zech16 + i);
  }
  const unsigned uord = (unsigned)ord;
  // logs of S_1..S_2T ([j - 1][frame], after the Zech table), from the
  // tables in global memory while the Zech table arrives
  unsigned* ls = reinterpret_cast<unsigned*>(smem + rows);
  if (warp == 0) {
    long long* So = S_out + (long long)frame * (2 * T);
    unsigned lsr[2 * T];
#pragma unroll
    for (int j = 1; j <= 2 * T; ++j) {
      unsigned v, l;
      if (j & 1) {
        const int k = (j - 1) / 2;
        v = (sw[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
        l = gf_log_g(log16, v);
      } else {                            // S_j = S_(j/2)^2
        const unsigned h = lsr[j / 2 - 1];
        l = h >= uord ? kZeroLog : wrap(2 * h, uord);
        v = gf_exp_g(exp16, l, uord);
      }
      lsr[j - 1] = l;
      if (dirty) ls[(j - 1) * 32 + lane] = l;
      if (live) So[j - 1] = v;
    }
    if (!dirty && live) {
      long long* sg = sigma_out + (long long)frame * (T + 1);
#pragma unroll
      for (int i = 0; i <= T; ++i) sg[i] = i == 0;
      L_out[frame] = 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!dirty) return;

  // Berlekamp-Massey in the log domain, 8 lanes a frame: lane r of frame
  // fr holds the coefficients i = r + 8q of C and x^m B. C(x) = B(x) = 1,
  // so x^m B(x) = x.
  constexpr int Q = (W + 7) / 8;
  const uint16_t* zt = reinterpret_cast<const uint16_t*>(smem);
  const int fr = warp * 4 + (lane >> 3), r = lane & 7;
  const unsigned* lsf = ls + fr;
  const int src_lane = (lane & ~7) | ((r + 7) & 7);
  unsigned lc[Q], lb[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    lc[q] = r + 8 * q == 0 ? 0u : kZeroLog;
    lb[q] = r + 8 * q == 1 ? 0u : kZeroLog;
  }
  unsigned logb = 0;
  int L = 0;
  for (int n = 0; n < 2 * T; ++n) {
    // log d = log XOR_i C[i] S[n - i] over i <= n: this lane's terms as a
    // tree, then the 8 lanes' sums joined by butterfly
    unsigned tm[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = r + 8 * q;
      tm[q] = i <= n ? gf_mul_log(lc[q], lsf[max(n - i, 0) * 32], uord)
                     : kZeroLog;
    }
    static_assert(Q == 3 || Q == 4, "t = 8, 10, 12");
    unsigned part = gf_add_log(zt, tm[0], tm[1], uord);
    part = gf_add_log(
        zt, part, Q == 4 ? gf_add_log(zt, tm[2], tm[Q - 1], uord) : tm[2],
        uord);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      part = gf_add_log(zt, part, __shfl_xor_sync(kFull, part, o), uord);
    const unsigned ld = part;
    const bool update = ld < uord;
    const bool grow = update && 2 * L <= n;
    const unsigned lq = wrap(ld + uord - logb, uord);   // log(d / b)
    unsigned lcn[Q], src[Q];              // C + (d / b) x^m B
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      lcn[q] = gf_add_log(zt, lc[q], gf_mul_log(lq, lb[q], uord), uord);
      src[q] = grow ? lc[q] : lb[q];
    }
    // x^m B(x): x C(x) after a length change (m = 1), else one more x;
    // coefficient i comes from i - 1: lane r - 1's slot q, or for lane 0
    // lane 7's slot q - 1 (lane 7 sends that one); cut at W coefficients
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const unsigned send = r == 7 ? (q ? src[q - 1] : kZeroLog) : src[q];
      const unsigned got = __shfl_sync(kFull, send, src_lane);
      lb[q] = r + 8 * q >= W ? kZeroLog : got;
    }
    if (grow) {
      L = n + 1 - L;
      logb = ld;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) lc[q] = update ? lcn[q] : lc[q];
  }
  const int frame_b = g * 32 + fr;
  if (frame_b < B) {
    long long* sg = sigma_out + (long long)frame_b * (T + 1);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (r + 8 * q <= T) sg[r + 8 * q] = gf_exp_g(exp16, lc[q], uord);
    }
    if (r == 0) L_out[frame_b] = L;
  }
}

__global__ void __launch_bounds__(kChienThreads, 1)
bch_chien_kernel(const long long* __restrict__ S,
                 const long long* __restrict__ sigma,
                 const long long* __restrict__ L_in,
                 const uint4* __restrict__ exp16,
                 const long long* __restrict__ log, uint8_t* __restrict__ out,
                 long long stride_b, long long stride_e,
                 int* __restrict__ n_corr, int t, int nbch, int ord) {
  extern __shared__ uint4 smem[];
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  __shared__ int s_count, s_nnz;
  __shared__ int s_roots[kMaxT];
  __shared__ int s_log[kMaxT + 1], s_deg[kMaxT + 1];
  const int f = blockIdx.x, tid = threadIdx.x;
  const int n_steps = 2 * t;
  // S, sigma and L in one round of reads; one barrier tells clean frames
  const long long L = L_in[f];
  const int s = tid <= t ? (int)sigma[(long long)f * (t + 1) + tid] : 0;
  const int dirty = __syncthreads_or(
      tid < n_steps && S[(long long)f * n_steps + tid] != 0);
  if (!dirty || L > t) {                  // block-uniform
    if (tid == 0) n_corr[f] = dirty ? -1 : 0;
    return;
  }
  const int rows = (ord + 7) / 8;
#pragma unroll
  for (int r = 0; r < kChienFill; ++r) {
    const int i = tid + r * kChienThreads;
    if (i < rows) cp_async16(smem + i, exp16 + i);
  }
  if (tid < 32) {                         // the nonzero coefficients, listed
    const unsigned nz = __ballot_sync(kFull, s != 0);
    if (s != 0) {
      const int k = __popc(nz & ((1u << tid) - 1));
      s_log[k] = (int)__ldg(&log[s]);
      s_deg[k] = tid;
    }
    if (tid == 0) {
      s_nnz = __popc(nz);
      s_count = 0;
    }
  }
  __syncthreads();
  // exponents (log sigma_i - i p) mod ord at this thread's first positions
  // e = tid (xa) and tid + 512 (xb); each step adds 1024 i mod ord (st)
  const unsigned uord = (unsigned)ord;
  const int m = __ffs(ord + 1) - 1;
  const int nnz = s_nnz;
  const int p0 = max(nbch - 1 - tid, 0);
  unsigned xa[kMaxT + 1], xb[kMaxT + 1], st[kMaxT + 1];
#pragma unroll
  for (int k = 0; k <= kMaxT; ++k) {
    xa[k] = xb[k] = st[k] = 0;
    if (k < nnz) {
      const unsigned i = (unsigned)s_deg[k];
      xa[k] = wrap((unsigned)s_log[k] + uord - fold(i * p0, uord, m), uord);
      xb[k] = wrap(xa[k] + fold(i * kChienThreads, uord, m), uord);
      st[k] = fold(i * 2 * kChienThreads, uord, m);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < nbch; e += 2 * kChienThreads) {
    unsigned va = 0, vb = 0;
#pragma unroll
    for (int k = 0; k <= kMaxT; ++k) {
      if (k >= nnz) break;                // block-uniform
      va ^= tab[xa[k]];
      vb ^= tab[xb[k]];
      xa[k] = wrap(xa[k] + st[k], uord);
      xb[k] = wrap(xb[k] + st[k], uord);
    }
    if (va == 0) {
      const int slot = atomicAdd(&s_count, 1);
      if (slot < kMaxT) s_roots[slot] = e;
    }
    if (vb == 0 && e + kChienThreads < nbch) {
      const int slot = atomicAdd(&s_count, 1);
      if (slot < kMaxT) s_roots[slot] = e + kChienThreads;
    }
  }
  __syncthreads();
  const int n_roots = s_count;
  const bool ok = n_roots == L;           // n_roots <= t: L <= t here
  if (ok && tid < n_roots) {
    out[(long long)f * stride_b + (long long)s_roots[tid] * stride_e] ^= 1;
  }
  if (tid == 0) n_corr[f] = ok ? n_roots : -1;
}

template <int T>
int launch_locator(const void* bits, const void* odd, const void* exp16,
                   const void* log16, const void* zech16, void* S,
                   void* sigma, void* L, void* scratch, int stride_b,
                   int stride_e, int B, int nbch, int ord, int chunks,
                   cudaStream_t stream) {
  constexpr int KW = (T + 3) / 4 * 2;
  const int groups = (B + 31) / 32;
  const int smem = max((ord + 1) * 2 + 2 * T * 32 * 4,
                       kStageQuads * 4 * (32 + KW * 4));
  const cudaError_t e = cudaFuncSetAttribute(
      bch_locator_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = stride_b == 1 && stride_e % 16 == 0 && B % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(bits) & 15) == 0;
  unsigned* acc = static_cast<unsigned*>(scratch);
  bch_locator_kernel<T><<<dim3(chunks, groups), kLocThreads, smem, stream>>>(
      (const uint8_t*)bits, stride_b, stride_e, (const unsigned*)odd,
      (const uint16_t*)exp16, (const uint16_t*)log16, (const uint4*)zech16,
      (long long*)S, (long long*)sigma, (long long*)L, acc,
      acc + (long long)groups * 32 * KW, B, nbch, ord, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: the locator's accumulators (ceil(B/32) x 32 x words per position,
// zero) and its arrival counters (ceil(B/32), zero); the kernel leaves both
// at zero
extern "C" int bch_locator_launch(const void* bits, const void* odd,
                                  const void* exp16, const void* log16,
                                  const void* zech16, void* S, void* sigma,
                                  void* L, void* scratch, int stride_b,
                                  int stride_e, int B, int t, int nbch,
                                  int ord, int chunks, void* stream) {
  if (B <= 0 || ord < 2 || ord > kMaxOrd || (ord & (ord + 1)) || nbch < 4 ||
      nbch % 4 || nbch > ord || chunks < 1 || chunks > nbch / 4 ||
      stride_b < 0 || stride_e < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 8:
      return launch_locator<8>(bits, odd, exp16, log16, zech16, S, sigma, L,
                               scratch, stride_b, stride_e, B, nbch, ord,
                               chunks, s);
    case 10:
      return launch_locator<10>(bits, odd, exp16, log16, zech16, S, sigma, L,
                                scratch, stride_b, stride_e, B, nbch, ord,
                                chunks, s);
    case 12:
      return launch_locator<12>(bits, odd, exp16, log16, zech16, S, sigma, L,
                                scratch, stride_b, stride_e, B, nbch, ord,
                                chunks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int bch_chien_launch(const void* S, const void* sigma,
                                const void* L, const void* exp16,
                                const void* log, void* out, int stride_b,
                                int stride_e, void* n_corr, int B, int t,
                                int nbch, int ord, void* stream) {
  if (B <= 0 || t < 1 || t > kMaxT || ord < 2 || ord > kMaxOrd ||
      (ord + 7) / 8 > kChienFill * kChienThreads || nbch < 1 || nbch > ord ||
      stride_b < 0 || stride_e < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (ord + 7) / 8 * 16;    // the antilog table, 16-bit words
  const cudaError_t e = cudaFuncSetAttribute(
      bch_chien_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bch_chien_kernel<<<B, kChienThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)S, (const long long*)sigma, (const long long*)L,
      (const uint4*)exp16, (const long long*)log, (uint8_t*)out, stride_b,
      stride_e, (int*)n_corr, t, nbch, ord);
  return (int)cudaGetLastError();
}
