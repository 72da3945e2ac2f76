// The shared front end of the stream receivers and the host receivers:
// block AGC, the rotator and the append to the right-aligned sample
// buffer, as two kernels.
//
// Replaces no Pallas kernel. The JAX package computes this as one XLA
// fusion chain: the stream step's ``frontend`` (dvbs2rx_tpu/rx/stream.py:
// 179-221: AGC on the block's mean magnitude, the rotator, the shift of
// the buffer by the block and the append) and ``rotate_block``
// (dvbs2rx_tpu/ops/frontend.py:32). The port ran it as ~40 PyTorch
// launches a step; its plain version stays in ops/frontend_cuda.py
// (``frontend_plain``, with the rotator's plain form ``rotate_plain``)
// and CPU tensors run it.
//
//   frontend_agc_kernel: grid (chunks, C). Each block sums
//     sqrt(x0^2 + x1^2) over kAgcChunk samples of its channel's block in
//     double and writes the sum to a scratch (C, chunks) of doubles.
//   frontend_rotate_kernel: grid (row tiles, C). Each block reduces its
//     channel's partial sums in a fixed order (lane k of warp 0 the chunks
//     k, k + 32, ..., then a shuffle tree; every block of a channel the
//     same order, so the same gain: no float atomics, a replay gives the
//     same bytes), forms gain' = (1 - alpha) gain + alpha agc_ref /
//     max(mean, 1e-12), and writes its tile of the output rows: with a
//     carried buffer (C, N, 2) the rows below N - n_in are the old
//     buffer's rows n_in.. (the shift), the rest the block's samples times
//     the gain, rotated by ph = phase0 + inc n; without one the rotated
//     block alone. The tile-0 block of each channel writes gain', the
//     rotator phase mod(phase0 + inc n_in, 2 pi), and with a buffer the
//     new fill min(sfill + n_in, N), the read start N - fill and the
//     overflow flag sfill > N - n_in.
//
// AGC modes: 0 off (no partial sums, no gain multiply: the block is
// rotated as it comes), 1 update (the step's AGC), 2 the given gain,
// applied and not updated (re-acquisition).
//
// Numerics. Element-wise products and sums round as the plain version's
// separate launches do (__fmul_rn, __fadd_rn: nvcc would contract a
// multiply feeding an add into an FMA). The rotator's phase is the one
// exception, and on purpose: ph = fma(inc, n, phase0) with one rounding,
// because XLA on the CPU contracts the JAX rotate_block's phase0 + inc * n
// into an FMA, and at n ~ 1e5 the two-rounding form moves ph by an ulp of
// a 1e5 rad angle (2^-7 rad; the plain version forms the FMA in float64,
// exact for these operands). sin and cos: ph
// (|ph| up to |inc| n_in, past 1e5 rad at the step's 133,128 samples) is
// reduced by pi/2 in double (a two-part pi/2, exact to ~1e-16 rad for any
// float32 ph below 2^31), and the reduced angle's sin and cos are Taylor
// polynomials in double to r^11 / r^12 (truncation < 1e-11 at pi/4),
// rounded once to float: correctly rounded but for a rare 1-ulp near a
// midpoint. CUDA's sinf / cosf would keep a local-memory stack frame for
// their large-argument path (phase 2 of chip_smoke.py refuses any), and
// the float Cody-Waite reduction of plsync.cu's sincos_bounded is stated
// only to |ph| < 1e5. The mean magnitude: a double sum in a fixed order,
// rounded once (torch's float32 mean sums in its own order: within an
// ulp or two).
//
// What bounds it. Device memory: at the CCM step (C = 64, n_in = 133,128,
// N = 200,755) the AGC kernel reads the block once (68.2 MB) and the
// rotate kernel reads it again, reads the carried rows (34.6 MB) and
// writes the new buffer (102.8 MB): ~274 MB, 0.082 ms at 3.35 TB/s; the
// function itself needs the block, the carried rows and the new buffer
// once, ~206 MB, 0.061 ms. The rotation's ~20 double operations and 4
// conversions a sample (8.5 M samples) take ~0.02 ms of the SMs' issue
// and hide under the loads. The copy is out of place in one pass (an
// in-place ring would save the carried rows' read and write).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAgcThreads = 256;
constexpr int kAgcChunk = 4096;              // samples a partial sum
constexpr int kRotThreads = 256;
constexpr int kRotPer = 8;                   // rows a thread
constexpr int kRotRows = kRotThreads * kRotPer;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// jnp.mod's float arithmetic (ops/cplx.mod): fmod, then a sign fix
__device__ __forceinline__ float mod_rn(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && ((r < 0.f) != (m < 0.f))) r = __fadd_rn(r, m);
  return r;
}

// sin and cos of a float angle of any size below 2^31: reduction by pi/2
// in double, Taylor polynomials in double, one rounding to float
__device__ __forceinline__ void sincos_rn(float ph, float* s, float* c) {
  const double kMagic = 6755399441055744.0;   // 1.5 x 2^52
  const double x = (double)ph;
  const double t = fma(x, 0.63661977236758134, kMagic);
  const int q = __double2loint(t);
  const double k = t - kMagic;
  double r = fma(k, -1.5707963267948966, x);
  r = fma(k, -6.123233995736766e-17, r);
  const double r2 = r * r;
  double ps = fma(r2, -1.0 / 39916800.0, 1.0 / 362880.0);
  ps = fma(ps, r2, -1.0 / 5040.0);
  ps = fma(ps, r2, 1.0 / 120.0);
  ps = fma(ps, r2, -1.0 / 6.0);
  ps = fma(ps * r2, r, r);
  double pc = fma(r2, 1.0 / 479001600.0, -1.0 / 3628800.0);
  pc = fma(pc, r2, 1.0 / 40320.0);
  pc = fma(pc, r2, -1.0 / 720.0);
  pc = fma(pc, r2, 1.0 / 24.0);
  pc = fma(pc, r2, -0.5);
  pc = fma(pc, r2, 1.0);
  const float fs = __double2float_rn(ps), fc = __double2float_rn(pc);
  const float sr = (q & 1) ? fc : fs;
  const float cr = (q & 1) ? fs : fc;
  *s = (q & 2) ? -sr : sr;
  *c = ((q + 1) & 2) ? -cr : cr;
}

__global__ void __launch_bounds__(kAgcThreads)
frontend_agc_kernel(const float2* __restrict__ iq, int n, int n_chunks,
                    double* __restrict__ part) {
  __shared__ double red[kAgcThreads / 32];
  const int c = blockIdx.y, k = blockIdx.x;
  const float2* x = iq + (long long)c * n;
  const int lo = k * kAgcChunk, hi = min(n, lo + kAgcChunk);
  double acc = 0.0;
  for (int i = lo + threadIdx.x; i < hi; i += kAgcThreads) {
    const float2 v = __ldg(x + i);
    acc += (double)__fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x),
                                        __fmul_rn(v.y, v.y)));
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kAgcThreads / 32; ++w) s += red[w];
    part[(long long)c * n_chunks + k] = s;
  }
}

struct RotArgs {
  const float2* iq;        // (C, n_in) samples
  const float2* old;       // (C, N) carried buffer, or null
  float2* out;             // (C, N) new buffer, or (C, n_in) without one
  const double* part;      // (C, n_chunks) AGC partial sums (mode 1)
  const float* gain_in;    // (C,)
  float* gain_out;         // (C,) (mode 1)
  const float* phase0;     // (C,)
  const float* inc;        // (C,)
  float* phase_out;        // (C,)
  const int* sfill_in;     // (C,) (with a buffer)
  int* sfill_out;
  int* start_out;
  uint8_t* overflow;
  int n_in, N, n_chunks, agc_mode;
  float one_minus_alpha, alpha, agc_ref, two_pi;
};

__global__ void __launch_bounds__(kRotThreads)
frontend_rotate_kernel(const RotArgs a) {
  __shared__ float s_gain;
  const int c = blockIdx.y;
  if (threadIdx.x < 32) {
    float g = a.agc_mode ? a.gain_in[c] : 1.f;
    if (a.agc_mode == 1) {
      double s = 0.0;
      for (int k = threadIdx.x; k < a.n_chunks; k += 32)
        s += a.part[(long long)c * a.n_chunks + k];
      s = warp_sum(s);
      const float mag = __double2float_rn(s / (double)a.n_in);
      const float target = __fdiv_rn(a.agc_ref, fmaxf(mag, 1e-12f));
      g = __fadd_rn(__fmul_rn(a.one_minus_alpha, g),
                    __fmul_rn(a.alpha, target));
    }
    if (threadIdx.x == 0) {
      s_gain = g;
      if (blockIdx.x == 0) {
        if (a.agc_mode == 1) a.gain_out[c] = g;
        a.phase_out[c] = mod_rn(
            __fmaf_rn(a.inc[c], (float)a.n_in, a.phase0[c]), a.two_pi);
        if (a.old) {
          const int f = a.sfill_in[c];
          const int nf = min(f + a.n_in, a.N);
          a.sfill_out[c] = nf;
          a.start_out[c] = a.N - nf;
          a.overflow[c] = f > a.N - a.n_in;
        }
      }
    }
  }
  __syncthreads();
  const float g = s_gain, ph0 = a.phase0[c], inc = a.inc[c];
  const int n_copy = a.old ? a.N - a.n_in : 0;
  const long long row0 = (long long)blockIdx.x * kRotRows;
  float2* out = a.out + (long long)c * a.N;
  const float2* old = a.old ? a.old + (long long)c * a.N + a.n_in : nullptr;
  const float2* iq = a.iq + (long long)c * a.n_in;
#pragma unroll
  for (int j = 0; j < kRotPer; ++j) {
    const long long r = row0 + threadIdx.x + j * kRotThreads;
    if (r < n_copy) {
      out[r] = __ldg(old + r);
    } else if (r < a.N) {
      const int n = (int)(r - n_copy);
      float2 x = __ldg(iq + n);
      if (a.agc_mode) x = make_float2(__fmul_rn(x.x, g), __fmul_rn(x.y, g));
      float sn, cs;
      sincos_rn(__fmaf_rn(inc, (float)n, ph0), &sn, &cs);
      // re = x0 c + (x1 s)(-1), im = x1 c + x0 s (the JAX form)
      out[r] = make_float2(__fadd_rn(__fmul_rn(x.x, cs), -__fmul_rn(x.y, sn)),
                           __fadd_rn(__fmul_rn(x.y, cs), __fmul_rn(x.x, sn)));
    }
  }
}

}  // namespace

extern "C" int frontend_chunk_samples() { return kAgcChunk; }

extern "C" int frontend_tile_rows() { return kRotRows; }

// One front-end block: the AGC partial sums (mode 1), then the rotation
// and the append. Pointers are device pointers of contiguous tensors;
// ``old`` null for the block alone (then sfill_*, start_out, overflow are
// not read or written).
extern "C" int frontend_launch(const void* iq, const void* old, void* out,
                               void* part, const void* gain_in,
                               void* gain_out, const void* phase0,
                               const void* inc, void* phase_out,
                               const void* sfill_in, void* sfill_out,
                               void* start_out, void* overflow, int C,
                               int n_in, int N, int agc_mode,
                               float one_minus_alpha, float alpha,
                               float agc_ref, float two_pi, void* stream) {
  if (C <= 0 || C > 65535 || n_in <= 0 || agc_mode < 0 || agc_mode > 2 ||
      (old ? N < n_in : N != n_in) || (agc_mode == 1 && !part) ||
      (agc_mode != 0 && !gain_in) || (agc_mode == 1 && !gain_out) ||
      (old && !(sfill_in && sfill_out && start_out && overflow))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (n_in + kAgcChunk - 1) / kAgcChunk;
  if (agc_mode == 1) {
    frontend_agc_kernel<<<dim3(n_chunks, C), kAgcThreads, 0, st>>>(
        (const float2*)iq, n_in, n_chunks, (double*)part);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const RotArgs a{(const float2*)iq, (const float2*)old, (float2*)out,
                  (const double*)part, (const float*)gain_in,
                  (float*)gain_out, (const float*)phase0, (const float*)inc,
                  (float*)phase_out, (const int*)sfill_in, (int*)sfill_out,
                  (int*)start_out, (uint8_t*)overflow, n_in, N, n_chunks,
                  agc_mode, one_minus_alpha, alpha, agc_ref, two_pi};
  const int tiles = (N + kRotRows - 1) / kRotRows;
  frontend_rotate_kernel<<<dim3(tiles, C), kRotThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
