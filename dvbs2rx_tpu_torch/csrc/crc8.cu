// CRC-8 validity map of descrambled BBFRAME bytes, for the TS stitch.
//
// No Pallas kernel precedes it. It replaces the JAX package's Kogge-Stone
// scan of constant 8x8 GF(2) matrices (dvbs2rx_tpu/ops/crc8_dev.py:78-130),
// which the port's plain version (ops/crc8_dev.py packet_validity_plain)
// runs as ~354 small XOR launches per call. For each frame row of n bytes:
//
//   ok[p]  = crc8(bytes[max(0, p - W) : p]) == bytes[p]     (W = window)
//   hdr_ok = crc8(bytes[0 : 9]) == bytes[9]
//
// CRC-8 with init 0, no reflection and no final XOR, so it is linear over
// GF(2): with M the state advance over one zero byte (M[x] = T[x], T the
// CRC table) and S[p] the inclusive prefix CRC of bytes 0..p (S[p] = 0 for
// p < 0), crc(bytes[p-W .. p-1]) = S[p-1] ^ M^W S[p-W-1]. Leading zero
// bytes leave the CRC unchanged, so a window that starts before the row is
// the max(0, p - W) rule (ok[0] tests bytes[0] == 0). ok is packed
// LSB-first into ceil(n/8) bytes per row, pad bits 0.
//
// Design: a scan of run CRCs. One block per frame; thread i owns the run of
// 16 bytes at 16 i (blockDim = 32 ceil(ceil(n/16) / 32): at n = 4,026 252
// of 256 threads have bytes, at 7,274 455 of 480).
//  1. load: the run's 16 bytes from two aligned 16-byte loads, shifted by
//     the row's address mod 16 (rows sit at f n, 2-byte aligned for the
//     paths' n; the same shift for every thread of a block), straight into
//     registers; the wrapper's tables (12.5 KB) into shared memory by
//     cp.async, all copies in flight at once (a register-staged fill took
//     twice the cycles, tools/torch_crc8_variants.py);
//  2. run CRC: the run's local prefix CRCs L at bytes 3, 7, 11, 15 by
//     slicing by 4, s' = U3[s ^ b0] ^ U2[b1] ^ U1[b2] ^ U0[b3] with
//     U_k = M^k T: a chain of 4 table reads;
//  3. scan: the state after each run, Kogge-Stone, e ^= A_k[e of the
//     run 2^k back] with A_k = M^(16 2^k), by warp shuffles within a warp
//     (levels 0-4); the warps' totals through shared memory, scanned by
//     shuffles with A_5..A_8; the state before the run is x = S[16 i - 1],
//     the warp-local one plus C_l[the warps before] (C_l = M^(16 l), one
//     barrier in all);
//  4. prefix: S at bytes 4g + 3 is L_g ^ P_g[x] (P_g = M^(4g + 4), four
//     independent reads), the others by a chain of three T steps from it;
//  5. window test: S to shared memory (one 16-byte store a thread), then
//     each thread reads the 16 S bytes W + 1 back (two 16-byte loads and
//     the block's shift) and tests S[p-1] ^ Z[S[p-W-1]] == b[p], Z = M^W;
//     hdr_ok is S[8] == b[9], both thread 0's;
//  6. write: two bytes of the packed map a thread, the header flag.
// What bounds it: latency. The loads (the row's, the tables') take ~2,000
// of a block's ~4,200 cycles at n = 4,026 by clock64() stamps; then ~54
// table reads a thread (16 run + 5-10 scan + 16 prefix + 16 test), each a
// random byte of a 256-byte table in shared memory (~2 wavefronts a warp),
// on a dependent chain of ~19 of them (4 + 5 + 4 + 1 + 1 + 3 + 1) and
// three barriers. The bytes (B n in, B n / 8 out) and one table step per
// byte, the function's own bound, take far less.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 16;                  // bytes per thread
constexpr int kMaxThreads = 512;
constexpr int kMaxN = kMaxThreads * kRun; // bytes per row
constexpr int kMaxWindow = 255;
constexpr int kPad = 256;                 // zeros before S: S[p < 0] = 0
constexpr int kLevels = 9;                // scan levels: up to 512 runs
// rows of the wrapper's (kTables, 256) table
constexpr int kU = 0;                     // U_k = M^k T, k = 0..3
constexpr int kP = 4;                     // P_g = M^(4g + 4), g = 0..3
constexpr int kZ = 8;                     // Z = M^W
constexpr int kA = 9;                     // A_k = M^(16 2^k), k = 0..8
constexpr int kTables = kA + kLevels;
// then C[v][l] = M^(16 l) v, l = 0..31: a lane's share of the warps
// before it, v-major so the 32 lanes read 32 consecutive bytes
constexpr int kC = kTables * 256;
constexpr int kTableBytes = kC + 256 * 32;

// bytes sh .. sh + 15 of the 32 bytes (lo, hi) as four words; sh is the
// same for every thread of the block, so the selects do not diverge
__device__ __forceinline__ void extract16(const uint4& lo, const uint4& hi,
                                          int sh, uint32_t out[4]) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = sh >> 2;
  const unsigned r = (unsigned)(sh & 3) * 8u;
  uint32_t v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    v[k] = q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[k + 3];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __funnelshift_r(v[k], v[k + 1], r);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t w[4], int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// one 16-byte copy from global to shared memory, in flight until waited for
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
crc8_validity_kernel(const uint8_t* __restrict__ frames,
                     const uint8_t* __restrict__ tables,
                     uint8_t* __restrict__ ok, int* __restrict__ hdr_ok,
                     int n, int n_packed, int window) {
  __shared__ __align__(16) uint8_t tab[kTableBytes];
  __shared__ __align__(16) uint8_t s_pref[kPad + kMaxN + 32];
  __shared__ uint8_t warp_total[kMaxThreads / 32];
  const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int runs = (n + kRun - 1) / kRun;
  const int p0 = tid * kRun;

  // 1. load: the run's bytes (zero past the row), the tables, the zeros
  uint32_t b[4] = {0u, 0u, 0u, 0u};
  if (p0 < n) {
    const uint8_t* row = frames + (long long)f * n;
    const uintptr_t a = (uintptr_t)(row + p0);
    const uintptr_t a0 = a & ~(uintptr_t)15;
    const uint4 lo = __ldg((const uint4*)a0);
    const uint4 hi = a0 + 16 < (uintptr_t)(row + n)
                         ? __ldg((const uint4*)(a0 + 16))
                         : make_uint4(0u, 0u, 0u, 0u);
    extract16(lo, hi, (int)(a & 15), b);
    const int len = n - p0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = min(max(len - 4 * k, 0), 4);
      b[k] &= v == 4 ? 0xffffffffu : (1u << (8 * v)) - 1u;
    }
  }
  for (int i = tid; i < kTableBytes / 16; i += blockDim.x)
    cp_async16((uint4*)tab + i, (const uint4*)tables + i);
  for (int i = tid; i < kPad / 16; i += blockDim.x)
    ((uint4*)s_pref)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. run CRC by slicing by 4: L[g] = the run's CRC of bytes 0 .. 4g + 3
  uint32_t L[4];
  uint32_t s = 0u;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t rest = tab[(kU + 2) * 256 + byte_of(b, 4 * g + 1)] ^
                          tab[(kU + 1) * 256 + byte_of(b, 4 * g + 2)] ^
                          tab[kU * 256 + byte_of(b, 4 * g + 3)];
    s = tab[(kU + 3) * 256 + (s ^ byte_of(b, 4 * g))] ^ rest;
    L[g] = s;
  }

  // 3. scan: e = the CRC state after this run from the warp's first run
  // (warp shuffles), then the warps' totals scanned by shuffles too, and x =
  // S[p0 - 1]: the state before this run from the warp's first run, plus
  // C_lane of the state after the warps before (advanced 16 lane bytes)
  uint32_t e = s;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    if (d < runs) {                       // the same for the whole block
      const uint32_t o = __shfl_up_sync(0xffffffffu, e, d);
      const uint32_t t = tab[(kA + k) * 256 + o];
      if (lane >= d) e ^= t;
    }
  }
  uint32_t x = __shfl_up_sync(0xffffffffu, e, 1);
  if (lane == 0) x = 0u;
  const int warps = blockDim.x >> 5, warp = tid >> 5;
  if (warps > 1) {
    if (lane == 31) warp_total[warp] = (uint8_t)e;
    __syncthreads();
    uint32_t w = lane < warps ? warp_total[lane] : 0u;
    for (int k = 0; (1 << k) < warps; ++k) {   // A_(5+k): 512 2^k bytes
      const int d = 1 << k;
      const uint32_t o = __shfl_up_sync(0xffffffffu, w, d);
      const uint32_t t = tab[(kA + 5 + k) * 256 + o];
      if (lane >= d) w ^= t;
    }
    const uint32_t before = __shfl_sync(0xffffffffu, w, max(warp - 1, 0));
    if (warp > 0) x ^= tab[kC + before * 32 + lane];
  }

  // 4. prefix: S[p0 + j], j = 0..15
  uint32_t S[kRun];
#pragma unroll
  for (int g = 0; g < 4; ++g) S[4 * g + 3] = L[g] ^ tab[(kP + g) * 256 + x];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t prev = g ? S[4 * g - 1] : x;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      prev = tab[kU * 256 + (prev ^ byte_of(b, 4 * g + m))];
      S[4 * g + m] = prev;
    }
  }

  // 5. window test: S[p - 1] ^ Z[S[p - W - 1]] == b[p]
  uint4 sw;
  sw.x = S[0] | S[1] << 8 | S[2] << 16 | S[3] << 24;
  sw.y = S[4] | S[5] << 8 | S[6] << 16 | S[7] << 24;
  sw.z = S[8] | S[9] << 8 | S[10] << 16 | S[11] << 24;
  sw.w = S[12] | S[13] << 8 | S[14] << 16 | S[15] << 24;
  *(uint4*)(s_pref + kPad + p0) = sw;
  __syncthreads();
  const int i0 = kPad + p0 - window - 1;
  const int base = i0 & ~15;
  uint32_t old[4];
  extract16(*(const uint4*)(s_pref + base), *(const uint4*)(s_pref + base + 16),
            i0 & 15, old);
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const uint32_t crc = (j ? S[j - 1] : x) ^ tab[kZ * 256 + byte_of(old, j)];
    bits |= (uint32_t)(crc == byte_of(b, j)) << j;
  }

  // 6. write
  if (p0 >= n) return;
  const int len = n - p0;
  if (len < kRun) bits &= (1u << len) - 1u;
  uint8_t* dst = ok + (long long)f * n_packed + p0 / 8;
  dst[0] = (uint8_t)bits;
  if (p0 / 8 + 1 < n_packed) dst[1] = (uint8_t)(bits >> 8);
  if (tid == 0) hdr_ok[f] = S[8] == byte_of(b, 9);
}

}  // namespace

extern "C" int crc8_validity_launch(const void* frames, const void* tables,
                                    void* ok, void* hdr_ok, int B, int n,
                                    int n_packed, int window, void* stream) {
  if (B <= 0 || n < 10 || n > kMaxN || n_packed != (n + 7) / 8 ||
      window < 1 || window > kMaxWindow || ((uintptr_t)tables & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int runs = (n + kRun - 1) / kRun;
  const int threads = (runs + 31) / 32 * 32;
  crc8_validity_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const uint8_t*)tables, (uint8_t*)ok,
      (int*)hdr_ok, n, n_packed, window);
  return (int)cudaGetLastError();
}
