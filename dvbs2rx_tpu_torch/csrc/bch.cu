// The BCH decoder's error locator (Berlekamp-Massey) and root search
// (Chien), after the syndrome product.
//
// Neither replaces a Pallas kernel. They replace the JAX package's
// lax.fori_loop of 2t Berlekamp-Massey rounds (dvbs2rx_tpu/ops/bch.py:
// 96-148) and its Chien product with the bit-plane matrix T
// (dvbs2rx_tpu/ops/bch.py:150-166) plus the correction masks (:179-187),
// which the port's plain versions (berlekamp_massey_plain, chien_plain
// and correct_plain in ops/bch.py) run as ~65 small launches per
// round and one float32 product with a ((t+1)m, nbch*m) matrix (431 MB for
// normal 1/2). Both kernels give the plain versions' integers bit for bit.
//
// bch_berlekamp_massey_kernel: one warp per frame. Lane i holds the
// coefficients C[i] and Bp[i] of the locator and of the last locator before
// a length change (width 2t + 1 <= 25 lanes), and lane j the syndrome S[j];
// all 2t rounds run in registers. A round's discrepancy is a warp XOR
// reduction of C[i] * S[n - i] (S fetched by shuffle), the shift of Bp by m
// positions is one shuffle, and the update rules (update, grow, L, m, b)
// are the plain loop's, applied to every frame, so an uncorrectable frame
// (L > t) gets the same truncated sigma and L as the plain version. GF
// products take the plain version's tables (exp with 2(2^m - 1) entries,
// indexed by log a + log b unreduced; a zero operand gives 0 and never
// reads log[0]). What bounds it: the latency of the round chain (per round
// about six dependent table reads through L1, five shuffles of the
// reduction and a few integer steps), not bytes or throughput: a batch of
// 128 frames is 32 blocks of 4 warps, a few microseconds.
//
// bch_chien_kernel: one block of 1,024 threads per frame. A frame that is
// clean (every syndrome 0) or whose locator is too long (L > t) decides its
// count at once and leaves the block. Otherwise the block copies the
// (2^m - 1)-entry antilog table into shared memory as 16-bit words (128 KB
// for m = 16) and evaluates sigma at alpha^(-p_e), p_e = nbch - 1 - e, for
// every bit position e in the log domain:
//     sigma(alpha^(-p_e)) = XOR_i exp[(log sigma_i - i p_e) mod (2^m - 1)]
// over the nonzero coefficients, with no T matrix. Thread k takes the
// positions k, k + 1024, ..., so every exponent grows by 1024 i from one of
// its positions to the next (one add and one wrap; 1024 t < 2^m - 1), and
// the lanes of a warp read neighbouring entries for each coefficient, at
// most a few lanes per bank. (A run of consecutive positions per thread put
// a warp's 32 lanes of a coefficient on one or two banks wherever the run
// was a multiple of 32, as at normal 1/2, and ran 3-4x slower there.)
// Roots are counted in shared memory (a degree <= t
// polynomial has at most t of them, each position a distinct point), the
// block synchronises, and only then, when the count equals L, are the
// roots' bits flipped. The wrapper passes a copy of the hard bits with its
// strides (rows of frames, or the lane-major (nbch, B) layout that
// decode_lane_major holds), so the kernel writes at most t bytes per frame
// and never reads the bits. What bounds it: the shared-memory table reads,
// (nonzero coefficients) per position, at 32 per cycle per SM with random
// bank conflicts: 128 frames of normal 1/2 with 12 errors each are 54 M
// reads, ~6.4 us at the LDS rate. A clean batch costs a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 12;                 // DVB-S2 BCH codes: t = 8, 10, 12
constexpr int kBmWarps = 4;               // frames per Berlekamp-Massey block
constexpr int kChienThreads = 1024;
constexpr int kMaxOrd = 65535;            // GF(2^16)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int gf_mul(const long long* __restrict__ exp,
                                      const long long* __restrict__ log,
                                      int a, int b) {
  if (a == 0 || b == 0) return 0;
  return (int)__ldg(&exp[__ldg(&log[a]) + __ldg(&log[b])]);
}

__global__ void __launch_bounds__(kBmWarps * 32)
bch_berlekamp_massey_kernel(const long long* __restrict__ S,
                            const long long* __restrict__ exp,
                            const long long* __restrict__ log,
                            long long* __restrict__ sigma,
                            long long* __restrict__ L_out, int B, int t,
                            int ord) {
  const int lane = threadIdx.x & 31;
  const int frame = blockIdx.x * kBmWarps + (threadIdx.x >> 5);
  if (frame >= B) return;                 // the whole warp leaves together
  const int n_steps = 2 * t, W = 2 * t + 1;
  const int s_mine =
      lane < n_steps ? (int)S[(long long)frame * n_steps + lane] : 0;
  int C = lane == 0 ? 1 : 0, Bp = C;      // C(x) = B(x) = 1
  int L = 0, m = 1, b = 1;                // warp-uniform
  for (int n = 0; n < n_steps; ++n) {
    // discrepancy d = XOR_i C[i] * S[n - i]
    const int src = n - lane;
    int s_val = __shfl_sync(kFull, s_mine, src & 31);
    if (src < 0 || lane >= W) s_val = 0;
    int d = gf_mul(exp, log, C, s_val);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d ^= __shfl_xor_sync(kFull, d, off);
    const int inv_b = (int)__ldg(&exp[(ord - __ldg(&log[b])) % ord]);
    const int coef = gf_mul(exp, log, d, inv_b);
    // C ^= coef * x^m Bp(x), truncated to W coefficients
    const int from = lane - m;
    int shifted = __shfl_sync(kFull, Bp, from & 31);
    if (from < 0 || lane >= W) shifted = 0;
    const int c_new = C ^ gf_mul(exp, log, coef, shifted);
    const bool update = d != 0;
    const bool grow = update && 2 * L <= n;
    if (grow) {
      Bp = C;
      L = n + 1 - L;
      b = d;
      m = 1;
    } else {
      ++m;
    }
    if (update) C = c_new;
  }
  if (lane <= t) sigma[(long long)frame * (t + 1) + lane] = C;
  if (lane == 0) L_out[frame] = L;
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
  __shared__ int s_dirty, s_count;
  __shared__ int s_roots[kMaxT];
  __shared__ int s_log[kMaxT + 1];
  const int f = blockIdx.x, tid = threadIdx.x;
  const int n_steps = 2 * t;
  if (tid == 0) {
    s_dirty = 0;
    s_count = 0;
  }
  __syncthreads();
  if (tid < n_steps && S[(long long)f * n_steps + tid] != 0) s_dirty = 1;
  if (tid <= t) {
    const int s = (int)sigma[(long long)f * (t + 1) + tid];
    s_log[tid] = s == 0 ? -1 : (int)__ldg(&log[s]);
  }
  __syncthreads();
  const long long L = L_in[f];
  if (!s_dirty || L > t) {                // block-uniform
    if (tid == 0) n_corr[f] = s_dirty ? -1 : 0;
    return;
  }
  for (int i = tid; i < (ord + 7) / 8; i += kChienThreads) smem[i] = exp16[i];
  // exponents (log sigma_i - i p_e) mod ord at this thread's first position
  // e = tid; the thread then steps by kChienThreads positions, which adds
  // i kChienThreads (< ord) to exponent i
  const int p0 = nbch - 1 - tid;
  int x[kMaxT + 1];
  unsigned nz = 0;
#pragma unroll
  for (int i = 0; i <= kMaxT; ++i) {
    x[i] = 0;
    if (i <= t && s_log[i] >= 0) {
      nz |= 1u << i;
      x[i] = (int)(((long long)s_log[i] - (long long)i * p0) % ord);
      if (x[i] < 0) x[i] += ord;
    }
  }
  __syncthreads();
  for (int e = tid; e < nbch; e += kChienThreads) {
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i <= kMaxT; ++i) {
      if (nz & (1u << i)) v ^= tab[x[i]];
      x[i] += i * kChienThreads;          // p_e falls by kChienThreads
      if (x[i] >= ord) x[i] -= ord;
    }
    if (v == 0) {
      const int slot = atomicAdd(&s_count, 1);
      if (slot < kMaxT) s_roots[slot] = e;
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

}  // namespace

extern "C" int bch_berlekamp_massey_launch(const void* S, const void* exp,
                                           const void* log, void* sigma,
                                           void* L, int B, int t, int ord,
                                           void* stream) {
  if (B <= 0 || t < 1 || t > kMaxT || ord < 2 || ord > kMaxOrd) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (B + kBmWarps - 1) / kBmWarps;
  bch_berlekamp_massey_kernel<<<grid, kBmWarps * 32, 0,
                                (cudaStream_t)stream>>>(
      (const long long*)S, (const long long*)exp, (const long long*)log,
      (long long*)sigma, (long long*)L, B, t, ord);
  return (int)cudaGetLastError();
}

extern "C" int bch_chien_launch(const void* S, const void* sigma,
                                const void* L, const void* exp16,
                                const void* log, void* out, int stride_b,
                                int stride_e, void* n_corr, int B, int t,
                                int nbch, int ord, void* stream) {
  if (B <= 0 || t < 1 || t > kMaxT || ord > kMaxOrd ||
      t * kChienThreads >= ord || nbch < 1 || nbch > ord || stride_b < 0 ||
      stride_e < 0) {
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
