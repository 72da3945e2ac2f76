// Post-decoder SNR refinement: per frame, the decoded codeword re-mapped to
// constellation points and measured against the frame's corrected symbols.
//
// No Pallas kernel precedes it. It replaces the PyTorch operators of the
// port's plain version (rx/receiver.py _snr_refine_frames, from the JAX
// receiver's _snr_refine_frames; reference xfecframe_demapper_cb_impl.cc
// :188-318) and, in the stream step, the refined-N0 update after it: an
// int64 cast of the hard bits, an index built bit by bit, a table gather
// and four reduction passes, 21 launches in all. For frame b of B, rows
// r < R of its symbols x (B, R, 2) float32 and its hard bits (B, N) uint8
// (N = rows n_mod):
//
//   idx[r]  = sum_k bit(b, p_k(r)) << (n_mod - 1 - k)      (MSB first)
//   p_k(r)  = r n_mod + k                (no bit interleaver, QPSK)
//           = order[k] rows + r          (the interleaver's column order)
//   ref     = points[idx]
//   sp      = sum_r |ref|^2,  np = sum_r |x - ref|^2
//   snr[b]  = sp / max(np, 1e-12)
//   n0'[b]  = snr > 0 ? 1 / max(snr, 1e-9) : n0[b]          (when n0 given)
//
// What bounds it: bytes. Each symbol is read once (8 B) and each of its
// n_mod bits once (1 B each); at the CCM stream step's shape (64 frames x
// 32,400 QPSK symbols, the bits rows of the LDPC kernel's (B, N) output)
// that is 16.6 + 4.1 MB, 0.0062 ms at 3.35 TB/s. The arithmetic (a table
// read and ~8 FLOPs a symbol) is far below it.
//
// Design: one block a tile of kRowTile symbol rows x kFrameTile frames, a
// warp a frame, its lanes neighbouring symbols (CCM: 127 x 8 blocks of
// 256 threads, ~20 KB each; all resident at once, every warp's loads in
// flight together). The bits follow their strides: where the bit axis is
// the unit-stride one ("rows": the LDPC kernel's (B, N) output, which the
// CCM, VCM and host paths pass), each lane reads its symbols' bits and the
// symbols straight from device memory; where the frame axis is ("lanes": a
// transposed view of lane-major (N, B) bits) a first pass reads each bit
// row across the tile's frames, along the unit stride, into a shared index
// tile. The points table (<= 32) lives in shared memory. Sums are float32:
// each lane adds its symbols in order, the warp by a fixed butterfly, and
// lane 0 writes the frame's tile partial to scratch. The block of a frame
// tile that arrives last (an integer ticket a frame tile, which it resets
// to 0 for the next launch, so a graph replays soundly) adds each of its
// frames' partials in tile order, kLoads a lane in flight, and writes snr
// and n0': no float atomics, the same sums on every run. Launches that
// share the tickets must run in stream order. On an H100 SXM (700 W) it
// takes 0.0148 ms at the CCM shape, 42% of the bound; a first design with
// 512-thread blocks of 64 frames, each warp's four frames and the one last
// block's 64 frames taken one after another, a latency each, took 0.0271.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 256;             // symbol rows a block
constexpr int kFrameTile = kWarps;        // frames a block: a warp a frame
constexpr int kPerLane = kRowTile / 32;   // symbols a lane takes of a frame
constexpr int kMaxMod = 5;
constexpr int kLoads = 4;                 // partials a lane has in flight
constexpr int kMaxFrameTiles = 4096;      // tickets: one a frame tile

struct Args {
  const float2* x;
  const uint8_t* bits;
  const float* points;     // (2^n_mod, 2)
  const float* n0_in;      // (B,) or null
  float* snr;
  float* n0_out;           // (B,) or null
  float2* partial;         // (tiles_r, B): (sp, np)
  unsigned int* ticket;     // (kMaxFrameTiles,)
  long long sxb;           // symbols from a frame's row to the next frame's
  long long sbb;           // bytes from a frame's bits to the next frame's
  long long step;          // bytes from symbol r's bit k to symbol r + 1's
  long long off[kMaxMod];  // bytes from a frame's bits to symbol 0's bit k
  int B, R, n_mod, tiles_r;
};

// the symbol index of row r of a frame's bits fb, MSB first
__device__ __forceinline__ int sym_index(const Args& a, const uint8_t* fb,
                                         int r) {
  const uint8_t* p = fb + (long long)r * a.step;
  int idx = 0;
#pragma unroll
  for (int k = 0; k < kMaxMod; ++k) {
    if (k < a.n_mod) idx = (idx << 1) | (p[a.off[k]] & 1);
  }
  return idx;
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
snr_refine_kernel(const __grid_constant__ Args a) {
  __shared__ float2 s_pts[1 << kMaxMod];
  __shared__ uint8_t s_idx[kLanes ? kFrameTile * kRowTile : 1];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRowTile, b0 = blockIdx.y * kFrameTile;
  const int nr = min(kRowTile, a.R - r0), nb = min(kFrameTile, a.B - b0);
  if (tid < (1 << a.n_mod)) {
    s_pts[tid] = make_float2(a.points[2 * tid], a.points[2 * tid + 1]);
  }
  if constexpr (kLanes) {
    // bit rows across the frames: neighbouring threads, neighbouring frames
    for (int e = tid; e < kRowTile * kFrameTile; e += kThreads) {
      const int b = e % kFrameTile, r = e / kFrameTile;
      if (b < nb && r < nr) {
        s_idx[b * kRowTile + r] = (uint8_t)sym_index(
            a, a.bits + (long long)(b0 + b) * a.sbb, r0 + r);
      }
    }
  }
  __syncthreads();

  if (warp < nb) {
    const int b = b0 + warp;
    const float2* xb = a.x + (long long)b * a.sxb + r0;
    const uint8_t* fb = a.bits + (long long)b * a.sbb;
    float2 acc = make_float2(0.f, 0.f);   // (sp, np)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int r = lane + 32 * j;
      if (r < nr) {
        int idx;
        if constexpr (kLanes) {
          idx = s_idx[warp * kRowTile + r];
        } else {
          idx = sym_index(a, fb, r0 + r);
        }
        const float2 v = xb[r], p = s_pts[idx];
        const float ex = v.x - p.x, ey = v.y - p.y;
        acc.x += p.x * p.x + p.y * p.y;
        acc.y += ex * ex + ey * ey;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      a.partial[(long long)blockIdx.x * a.B + b] = acc;
      __threadfence();
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(a.ticket + blockIdx.y, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block of the frame tile: each frame's tile partials in tile
  // order (lane l the tiles l, l + 32, ...; kLoads of them in flight), a
  // warp a frame
  if (warp < nb) {
    const int b = b0 + warp;
    float2 acc = make_float2(0.f, 0.f);
    for (int t0 = lane; t0 < a.tiles_r; t0 += 32 * kLoads) {
      float2 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int t = t0 + 32 * i;
        v[i] = t < a.tiles_r ? __ldcg(a.partial + (long long)t * a.B + b)
                             : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        acc.x += v[i].x;
        acc.y += v[i].y;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      // the clamps pass a NaN through, as torch.clamp does
      const float s = acc.x / (acc.y < 1e-12f ? 1e-12f : acc.y);
      a.snr[b] = s;
      if (a.n0_out) {
        a.n0_out[b] = s > 0.f ? 1.f / (s < 1e-9f ? 1e-9f : s) : a.n0_in[b];
      }
    }
  }
  if (tid == 0) a.ticket[blockIdx.y] = 0u;
}

}  // namespace

// order: -1 without an interleaver (bit k of symbol r at r n_mod + k), else
// the column order, order[k] in bits 3k..3k+2 (bit k at order[k] rows + r)
extern "C" int snr_refine_launch(
    const void* x, const void* bits, const void* points, const void* n0_in,
    void* snr, void* n0_out, void* partial, void* ticket, long long sxb,
    long long sbb, long long sbn, int B, int R, int rows, int n_mod,
    int order, int lanes, void* stream) {
  if (B <= 0 || R <= 0 || R > rows || n_mod < 1 || n_mod > kMaxMod ||
      (n0_in == nullptr) != (n0_out == nullptr) || ((uintptr_t)x & 7) ||
      B > kMaxFrameTiles * kFrameTile) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const float2*)x, (const uint8_t*)bits, (const float*)points,
         (const float*)n0_in, (float*)snr, (float*)n0_out, (float2*)partial,
         (unsigned int*)ticket, sxb, sbb, 0, {0, 0, 0, 0, 0}, B, R, n_mod,
         (R + kRowTile - 1) / kRowTile};
  a.step = order < 0 ? n_mod * sbn : sbn;
  for (int k = 0; k < n_mod; ++k) {
    const int col = (order >> (3 * k)) & 7;
    if (order >= 0 && col >= n_mod) return (int)cudaErrorInvalidValue;
    a.off[k] = order < 0 ? k * sbn : (long long)col * rows * sbn;
  }
  const dim3 grid(a.tiles_r, (B + kFrameTile - 1) / kFrameTile);
  if (lanes) {
    snr_refine_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    snr_refine_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
