// Layered offset-min-sum LDPC decoder for DVB-S2 quasi-cyclic codes.
//
// Replaces the Pallas kernel dvbs2rx_tpu/ops/ldpc_pallas.py::_build_kernel
// (its inner `kernel`, reached through PallasLDPCDecoder.decode_lane_major
// and __call__). Same arithmetic, bit for bit, as that kernel and as the
// roll-based decoder dvbs2rx_tpu/ops/ldpc.py (and its port ops/ldpc.py):
//
//   * beta = 1 offset min-sum in saturating int8:
//       inp   = clip(val - old_msg, -128, 127)
//       mag   = max(min(|inp|, 127) - 1, 0)
//       out   = +-(exclusive min of mag), sign = XOR of the other signs
//       msg   = clip(out, -32, 31)                  (stored message)
//       delta = clip(inp + out, -128, 127) - val    (unclamped out)
//       val'  = sat8(val + delta)                   (write-back)
//   * every edge value of a layer is read BEFORE the layer's first write;
//     deltas are written back edge by edge in edge order, with a barrier
//     before an edge whose block an earlier edge of the layer already wrote
//     (8 of S2_B4's 90 layers name a block twice, and saturating deltas do
//     not commute);
//   * iteration 0 treats the old messages as 0, so the message buffer needs
//     no initialisation;
//   * layer 0 has no previous-parity edge at check row 0: its value is 127
//     in both the update and the parity check, its message and delta 0;
//   * the parity check runs before the first iteration and after each one
//     (a zero LLR counts as unsatisfied) and stops the frame's decode.
//
// Layout: one CTA per frame. The JAX kernel's per-lane freeze makes every
// frame's result independent of its batch, so frames decode independently
// and B = 128 frames fill one wave of the H100's 132 SMs. One thread per
// check row (360 rows in 12 warps). The frame's variable state -- data
// blocks v[b][m] at b*360 + m, parity rows p[i][m] at K + i*360 + m -- sits
// in dynamic shared memory (N bytes, 64,800 for normal frames); the cyclic
// rolls of the TPU kernel are index arithmetic:
//   roll(v[b], s)[r] = v[b][(r - s) mod 360].
// Check messages live in device memory as [B][q][max_deg][360] int8
// (29 MB at B = 128 on S2_B4, resident in the 50 MB L2), coalesced by row.
//
// What bounds it on the card: latency and shared-memory barriers, not
// bandwidth or arithmetic. Each layer is a short dependent chain (E shared
// loads, an E-long min/sign scan, E read-modify-writes) separated by
// __syncthreads(), with one coalesced message load per edge. The design
// keeps the whole codeword in shared memory for every iteration (no device
// memory traffic for the state), places barriers only where the edge
// order requires them, and stops each frame at its own convergence rather
// than the batch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 360;          // check rows per layer (DVB-S2 M)
constexpr int kThreads = 384;    // 12 warps; rows 360..383 idle
constexpr int kMaxE = 32;        // max edges per check (data + 2 parity)
constexpr int kDead = -1;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Shared-state address of edge c of layer i at check row r.
__device__ __forceinline__ int edge_addr(int i, int c, int D, int e0, int r,
                                         const int* __restrict__ ebase,
                                         const int* __restrict__ eshift,
                                         int K, int q) {
  if (c < D) {
    int m = r - eshift[e0 + c];
    if (m < 0) m += kM;
    return ebase[e0 + c] + m;
  }
  if (c == D) return K + i * kM + r;                 // own parity
  if (i > 0) return K + (i - 1) * kM + r;            // previous parity
  return r == 0 ? kDead : K + (q - 1) * kM + (r - 1);
}

// Block-wide parity check: true when any check of the frame is unsatisfied.
__device__ bool frame_bad(const int8_t* s, const int* __restrict__ lptr,
                          const int* __restrict__ ebase,
                          const int* __restrict__ eshift, int K, int q) {
  const int r = threadIdx.x;
  int bad = 0;
  if (r < kM) {
    for (int i = 0; i < q; ++i) {
      const int e0 = lptr[i];
      const int D = lptr[i + 1] - e0;
      int sgn = 0, zero = 0;
      for (int c = 0; c < D + 2; ++c) {
        const int a = edge_addr(i, c, D, e0, r, ebase, eshift, K, q);
        if (a == kDead) continue;
        const int v = s[a];
        sgn ^= (v < 0);
        zero |= (v == 0);
      }
      bad |= sgn | zero;
    }
  }
  return __syncthreads_or(bad) != 0;
}

__global__ void __launch_bounds__(kThreads) ldpc_layered_kernel(
    const int8_t* __restrict__ llr_in,   // (B, N)
    int8_t* __restrict__ llr_out,        // (B, N)
    uint8_t* __restrict__ hard,          // (B, N)
    int8_t* __restrict__ msgs,           // (B, q, max_deg, 360)
    int* __restrict__ iters,             // (B,)
    int* __restrict__ conv,              // (B,)
    const int* __restrict__ lptr,        // (q + 1,) data-edge offsets
    const int* __restrict__ ebase,       // per data edge: block * 360
    const int* __restrict__ eshift,      // per data edge: cyclic shift
    const int* __restrict__ esync,       // per data edge: barrier first
    int N, int K, int q, int max_deg, int max_trials) {
  extern __shared__ int8_t s[];
  const int f = blockIdx.x;
  const int r = threadIdx.x;
  const int8_t* in = llr_in + (size_t)f * N;
  int8_t* mf = msgs + (size_t)f * q * max_deg * kM;

  for (int n = r; n < K; n += blockDim.x) s[n] = in[n];
  for (int n = K + r; n < N; n += blockDim.x) {
    const int j = n - K;                 // LLR index K + m*q + i -> p[i][m]
    s[K + (j % q) * kM + j / q] = in[n];
  }
  __syncthreads();

  bool bad = frame_bad(s, lptr, ebase, eshift, K, q);
  int it = 0;
  while (bad && it < max_trials) {
    for (int i = 0; i < q; ++i) {
      const int e0 = lptr[i];
      const int D = lptr[i + 1] - e0;
      const int E = D + 2;
      int8_t* mrow = mf + (size_t)i * max_deg * kM;
      int val[kMaxE], inp[kMaxE];
      int min0 = 0, min1 = 0x7fff, sgn = 0;
      if (r < kM) {
        // read phase: every edge value before any write of this layer
        for (int c = 0; c < E; ++c) {
          const int a = edge_addr(i, c, D, e0, r, ebase, eshift, K, q);
          const int v = (a == kDead) ? 127 : s[a];
          const int old = (it == 0 || a == kDead) ? 0 : mrow[c * kM + r];
          const int x = clampi(v - old, -128, 127);
          const int mag = max(min(abs(x), 127) - 1, 0);
          if (c == 0) {
            min0 = mag;
          } else if (mag < min0) {
            min1 = min0;
            min0 = mag;
          } else {
            min1 = min(min1, mag);
          }
          sgn ^= (x < 0);
          val[c] = v;
          inp[c] = x;
        }
      }
      __syncthreads();
      // write phase, edge by edge in edge order
      for (int c = 0; c < E; ++c) {
        if (c < D && esync[e0 + c]) __syncthreads();
        if (r < kM) {
          const int x = inp[c];
          const int mag = max(min(abs(x), 127) - 1, 0);
          const int excl = (mag == min0) ? min1 : min0;
          const int out = (sgn ^ (x < 0)) ? -excl : excl;
          const int a = edge_addr(i, c, D, e0, r, ebase, eshift, K, q);
          if (a == kDead) {
            mrow[c * kM + r] = 0;
          } else {
            mrow[c * kM + r] = (int8_t)clampi(out, -32, 31);
            const int delta = clampi(x + out, -128, 127) - val[c];
            s[a] = (int8_t)clampi(s[a] + delta, -128, 127);
          }
        }
      }
      __syncthreads();
    }
    ++it;
    bad = frame_bad(s, lptr, ebase, eshift, K, q);
  }

  int8_t* out = llr_out + (size_t)f * N;
  uint8_t* h = hard + (size_t)f * N;
  for (int n = r; n < N; n += blockDim.x) {
    int8_t v;
    if (n < K) {
      v = s[n];
    } else {
      const int j = n - K;
      v = s[K + (j % q) * kM + j / q];
    }
    out[n] = v;
    h[n] = v < 0;
  }
  if (r == 0) {
    iters[f] = it;
    conv[f] = !bad;
  }
}

}  // namespace

extern "C" int ldpc_layered_launch(const void* llr_in, void* llr_out,
                                   void* hard, void* msgs, void* iters,
                                   void* conv, const void* lptr,
                                   const void* ebase, const void* eshift,
                                   const void* esync, int B, int N, int K,
                                   int q, int max_deg, int max_trials,
                                   void* stream) {
  if (B <= 0 || q < 2 || max_deg > kMaxE || N - K != q * kM) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      ldpc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, N);
  if (e != cudaSuccess) return (int)e;
  ldpc_layered_kernel<<<B, kThreads, N, (cudaStream_t)stream>>>(
      (const int8_t*)llr_in, (int8_t*)llr_out, (uint8_t*)hard,
      (int8_t*)msgs, (int*)iters, (int*)conv, (const int*)lptr,
      (const int*)ebase, (const int*)eshift, (const int*)esync, N, K, q,
      max_deg, max_trials);
  return (int)cudaGetLastError();
}
