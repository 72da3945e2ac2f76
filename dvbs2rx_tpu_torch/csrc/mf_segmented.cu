// Segmented polyphase RRC matched filter fused with decimation.
//
// Replaces the Pallas kernel dvbs2rx_tpu/ops/pallas_fir.py::_seg_kernel
// (launched by _mf_pallas, reached through mf_segmented / mf_decimate):
//
//   y[c, s*seg_len + k] =
//       sum_l x[c, s*seg_len*sps + clip(base[c,s], 0, off_bound) + sps*k + l]
//             * taps[c, s, l]
//
// in exact float32 (FMA, no TF32), x and y planar (re, im) pairs.
//
// What bounds it on the card: memory. At the stream receiver's headline
// shape (64 channels x 15 segments x 4,332 symbols, 21 taps) each step
// reads ~66 MB of samples and writes ~33 MB of symbols against ~0.5 GFLOP,
// far below the H100's FLOP/byte balance. The design therefore reads every
// input sample from device memory once, coalesced: a block stages its
// tile's contiguous sample window (sps*TILE + L - 1 pairs) in shared memory
// with consecutive threads on consecutive pairs, then each thread computes
// one output symbol from shared memory with the segment's taps. The TPU
// kernel's phase split and roll-instead-of-slice machinery were Mosaic
// constraints (no strided lane access, 128-aligned DMA starts) and are
// gone: the whole-sample offset is plain index arithmetic here.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // output symbols per block (one per thread)
constexpr int kMaxTaps = 64;

__global__ void __launch_bounds__(kTile) mf_segmented_kernel(
    const float2* __restrict__ x,     // (C, n) pairs
    const float* __restrict__ taps,   // (C, S, L)
    const int* __restrict__ base,     // (C, S)
    float2* __restrict__ y,           // (C, S*seg_len) pairs
    int n, int S, int seg_len, int L, int sps, int off_bound) {
  extern __shared__ float2 win[];
  __shared__ float t[kMaxTaps];
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int cs = c * S + s;
  // the silent clip of pallas_fir.py::_extend_taps (both JAX paths apply it)
  const int off = min(max(base[cs], 0), off_bound);
  const long long start =
      (long long)s * seg_len * sps + off + (long long)sps * k0;
  const float2* xc = x + (long long)c * n;
  const int wlen = sps * (kTile - 1) + L;
  for (int i = threadIdx.x; i < wlen; i += blockDim.x) {
    const long long idx = start + i;
    win[i] = idx < n ? xc[idx] : make_float2(0.f, 0.f);
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) t[i] = taps[cs * L + i];
  __syncthreads();
  const int k = k0 + threadIdx.x;
  if (k >= seg_len) return;
  const float2* w = win + sps * threadIdx.x;
  float re = 0.f, im = 0.f;
  for (int l = 0; l < L; ++l) {
    const float2 v = w[l];
    re = fmaf(v.x, t[l], re);
    im = fmaf(v.y, t[l], im);
  }
  y[(long long)c * S * seg_len + (long long)s * seg_len + k] =
      make_float2(re, im);
}

}  // namespace

extern "C" int mf_segmented_launch(const void* x, const void* taps,
                                   const void* base, void* y, int C, int n,
                                   int S, int seg_len, int L, int sps,
                                   int off_bound, void* stream) {
  if (L > kMaxTaps || C <= 0 || S <= 0 || seg_len <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((seg_len + kTile - 1) / kTile, S, C);
  const size_t smem = sizeof(float2) * (size_t)(sps * (kTile - 1) + L);
  mf_segmented_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)taps, (const int*)base, (float2*)y, n,
      S, seg_len, L, sps, off_bound);
  return (int)cudaGetLastError();
}
