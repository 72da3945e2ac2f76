// Segmented polyphase RRC matched filter fused with decimation.
//
// Replaces the Pallas kernel dvbs2rx_tpu/ops/pallas_fir.py::_seg_kernel
// (launched by _mf_pallas, reached through mf_segmented / mf_decimate):
//
//   y[c, s*seg_len + k] =
//       sum_l x[c, s*seg_len*sps + clip(base[c,s], 0, off_bound) + sps*k + l]
//             * taps[c, s, l]
//
// in exact float32 (FMA, no TF32), x and y planar (re, im) pairs. With a
// per-channel start (C,), x[c] is the `length` rows of a longer buffer
// from clamp(start[c], 0, n - length) (jax.lax.dynamic_slice's clamp):
// the stream receivers' right-aligned sample buffer, read in place.
//
// What bounds it on the card: device memory. At the stream receiver's
// headline shape (64 channels x 15 segments x 4,332 symbols, 21 taps,
// sps 2) a call reads 66.6 MB of samples and writes 33.3 MB of symbols:
// 99.9 MB, 29.8 us at 3.35 TB/s, against 0.35 GFLOP (about 3.5 FLOP per
// byte, far below the card's balance; 5.2 us at 67 TFLOP/s). The tensor
// cores do not apply: there is no product to batch, only 21 taps per
// output, and the work is bytes. The kernel is CUDA C++, not Triton.
//
// The first design (one output per thread, 8-byte loads, the taps re-read
// from shared memory in a loop that did not unroll) was held back by the
// shared-memory pipe: per warp of 32 outputs, 21 taps x (4 wavefronts for
// a window read with a 16-byte thread stride + 1 for the tap) = ~105
// wavefronts, ~3.3 per output, ~52 us per call on 132 SMs at 1.98 GHz.
// This design:
//
// 1. Taps in registers: a template on the tap count, zero-padded to a
//    bucket (24 or 64), loops fully unrolled so every tap index is known at
//    compile time.
// 2. kR = 8 consecutive outputs per thread from a sliding register window:
//    at sps = 2 a thread reads 2 (kR - 1) + 24 + 1 samples once, as 16-byte
//    LDS.128 (two samples each: 19 or 20 vectors for 8 outputs), and
//    folds each sample into every output it touches.
// 3. A conflict-free shared layout: one 16-byte slot of padding after every
//    8 vectors (slot = v + v / 8), so the 8 threads of a quarter-warp, 8
//    vectors apart, land on 8 different bank groups for the window reads,
//    the staging writes and the coalesced reads back.
//    Shared-memory wavefronts per output at the main-path shape: window
//    reads 20 / 8 vectors x 1/8 = 0.31 per computed output, x 1,024 / 868
//    thread slots per item = 0.37; window writes (cp.async, 1,036 vectors
//    per 868 outputs) 0.15; output staging write and read 0.125; taps 0.03:
//    ~0.67, against ~3.3 before (~5x fewer). The idle slots of a chunk
//    keep it above 0.5; the pipe is no longer the limit (with the FIR
//    arithmetic taken out the kernel is only ~3-5% faster).
// 4. Loads overlapped with compute in a persistent grid: as many blocks as
//    fit on the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs;
//    4 per SM at the main-path shape, held by shared memory), each walking
//    work items (channel, segment, chunk of up to kChunkMax outputs; the
//    wrapper's plan, fir_cuda.launch_plan, balances the chunks of a
//    segment) through a ring of kStages sample windows in dynamic shared
//    memory: the next item's window and taps are fetched with 16-byte
//    cp.async.cg (commit groups, with an L2 256-byte prefetch hint) while
//    this item computes. A window starts at an arbitrary sample, so it is
//    fetched from its start rounded down to 16 bytes (one sample earlier at
//    most, inside the same 16-byte granule as the first sample, so the read
//    cannot fault), and the compute index is shifted by that sample (a
//    uniform branch between two unrolled bodies). Bytes past the window's
//    end are zero-filled by cp.async's source size, never read, so the
//    zero-padded taps meet zeros. The items of a main-path call: 64 x 15 x
//    5 chunks of 868 (the last 860) = 4,800 items, 46,688 B per block.
//    Deeper rings (3 stages: 3 blocks per SM), 64- and 256-thread blocks,
//    16 outputs per thread and a grid that gives every block the same
//    item count were each no faster (tools/torch_mf_variants.py).
// 5. Outputs staged in shared memory and written back as coalesced 16-byte
//    stores (8-byte stores where an odd seg_len leaves the chunk's first
//    output off a 16-byte boundary).
//
// sps = 2 (RxConfig's default, the main path) is the specialised body;
// any other integer sps runs the generic body (runtime sps, taps still in
// registers, 8-byte window reads). The dynamic shared memory is raised
// above 48 KB with cudaFuncSetAttribute once per instantiation, when its
// ring needs it (the generic body at sps >= 3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 8;                        // outputs per thread
constexpr int kStages = 2;                   // ring depth (windows in flight)
constexpr int kChunkMax = kThreads * kR;     // outputs per work item
constexpr int kMaxTaps = 64;
constexpr int kSmemLimit = 232448;           // per block on Hopper
static_assert(kR % 8 == 0, "fir2 assumes a thread's window starts a row");
static_assert(kThreads >= kMaxTaps, "one thread per tap fetches the taps");

// slot of 16-byte vector v: one slot of padding after every 8
__host__ __device__ constexpr int padded(int v) { return v + (v >> 3); }

__host__ __device__ constexpr int tap_bucket(int L) {
  return L <= 24 ? 24 : kMaxTaps;
}

// 16-byte vectors of one ring stage: kChunkMax outputs' window plus one
// sample of alignment shift
__host__ __device__ constexpr int stage_vectors(int sps, int lmax) {
  return (2 + sps * (kChunkMax - 1) + lmax) / 2;
}

// the ring's window stages, the output stage, the ring's tap stages
__host__ __device__ constexpr int smem_bytes(int sps, int lmax) {
  return 16 * (kStages * padded(stage_vectors(sps, lmax)) +
               padded(kChunkMax / 2) + kStages * lmax / 4);
}

struct Args {
  const float2* x;      // (C, n) pairs
  const float* taps;    // (C, S, L)
  const int* base;      // (C, S)
  float2* y;            // (C, S*seg_len) pairs
  const int* start;     // (C,) block starts in x's rows, or null
  int n, S, seg_len, L, sps, off_bound, chunk, n_chunks, items, length;
};

struct Item {
  int c, s, k0, cnt, off;
};

// work item it (offset still to be set)
__device__ __forceinline__ Item item_at(const Args& a, int it) {
  Item m;
  const int per_c = a.S * a.n_chunks;
  m.c = it / per_c;
  const int r = it - m.c * per_c;
  m.s = r / a.n_chunks;
  m.k0 = (r - m.s * a.n_chunks) * a.chunk;
  m.cnt = min(a.chunk, a.seg_len - m.k0);
  m.off = 0;
  return m;
}

// the item's offset, with the silent clip of pallas_fir.py::_extend_taps
// (both JAX paths apply it)
__device__ __forceinline__ int offset_of(const Args& a, int it) {
  const Item m = item_at(a, it);
  return min(max(__ldg(a.base + m.c * a.S + m.s), 0), a.off_bound);
}

// the channel's block start in x's rows (0 without per-channel starts)
__device__ __forceinline__ int block_start(const Args& a, int c) {
  return a.start ? min(max(__ldg(a.start + c), 0), a.n - a.length) : 0;
}

// address of the item's first window sample
__device__ __forceinline__ uintptr_t window_addr(const Args& a, const Item& m,
                                                 int sps) {
  const long long start = (long long)m.s * a.seg_len * sps + m.off +
                          (long long)sps * m.k0 + block_start(a, m.c);
  return (uintptr_t)(a.x + (long long)m.c * a.n + start);
}

// 16 bytes (zero-filled past `bytes`), bypassing L1, with a hint that L2
// fetch the 256-byte block around it (the window runs on contiguously)
__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start fetching an item's window (from its start rounded down to 16
// bytes, zero-filled past its end) and taps (zero-padded to LMAX).
template <int LMAX>
__device__ __forceinline__ void fetch(const Args& a, const Item& m, int sps,
                                      int nv, float4* win, float* tap) {
  const uintptr_t addr = window_addr(a, m, sps);
  const uintptr_t a0 = addr & ~(uintptr_t)15;
  const uintptr_t end = addr + 8ull * (sps * (m.cnt - 1) + a.L);
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const uintptr_t p = a0 + 16ull * v;
    float4* d = win + padded(v);
    if (p < end) {
      cp_async16(d, p, end - p >= 16 ? 16 : (int)(end - p));
    } else {
      *d = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (threadIdx.x < LMAX) {
    if (threadIdx.x < a.L) {
      cp_async4(tap + threadIdx.x,
                a.taps + (long long)(m.c * a.S + m.s) * a.L + threadIdx.x);
    } else {
      tap[threadIdx.x] = 0.f;
    }
  }
}

// sps = 2: the thread's kR outputs from one pass over its window, each
// sample (vector j, half h) folded into every output that it reaches.
// SH: the window's first sample sits in the second half of vector 0.
template <int LMAX, int SH>
__device__ __forceinline__ void fir2(const float4* win, const float (&t)[LMAX],
                                     float (&re)[kR], float (&im)[kR]) {
  constexpr int NVEC = (SH + 2 * (kR - 1) + LMAX + 1) / 2;
  const float4* w = win + padded(kR * threadIdx.x);
#pragma unroll
  for (int j = 0; j < NVEC; ++j) {
    const float4 q = w[j + (j >> 3)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xr = h ? q.z : q.x;
      const float xi = h ? q.w : q.y;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int l = 2 * j + h - SH - 2 * r;
        if (l >= 0 && l < LMAX) {
          re[r] = fmaf(xr, t[l], re[r]);
          im[r] = fmaf(xi, t[l], im[r]);
        }
      }
    }
  }
}

// any sps: sample j of the window read as one 8-byte pair
template <int LMAX>
__device__ __forceinline__ void fir_any(const float4* win, int sps, int sh,
                                        const float (&t)[LMAX],
                                        float (&re)[kR], float (&im)[kR]) {
  const float2* w2 = reinterpret_cast<const float2*>(win);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int j0 = sh + sps * (kR * threadIdx.x + r);
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      const int j = j0 + l;
      const float2 v = w2[2 * padded(j >> 1) + (j & 1)];
      re[r] = fmaf(v.x, t[l], re[r]);
      im[r] = fmaf(v.y, t[l], im[r]);
    }
  }
}

template <int SPS, int LMAX>
__global__ void __launch_bounds__(kThreads) mf_segmented_kernel(const Args a) {
  extern __shared__ float4 smem[];
  __shared__ int stage_off[kStages];
  const int sps = SPS ? SPS : a.sps;
  const int nv = stage_vectors(sps, LMAX);
  const int stage = padded(nv);
  float4* outs = smem + kStages * stage;
  float* tap_ring = reinterpret_cast<float*>(outs + padded(kChunkMax / 2));
  const int G = gridDim.x;

  // Ring: item i (the i-th of this block) lives in stage i % kStages;
  // kStages - 1 items are in flight while one computes.
  int f = blockIdx.x;                 // next item to fetch
  auto fetch_item = [&](int i, int off) {
    Item m = item_at(a, f);
    m.off = off;
    const int st = i % kStages;
    fetch<LMAX>(a, m, sps, nv, smem + st * stage, tap_ring + st * LMAX);
    if (threadIdx.x == 0) stage_off[st] = off;
  };
  int fi = 0;                         // this block's count of fetched items
  for (; fi < kStages - 1; ++fi, f += G) {
    if (f < a.items) fetch_item(fi, offset_of(a, f));
    cp_async_commit();
  }
  // the offset of the next fetch is loaded one item ahead of its use
  int off_f = f < a.items ? offset_of(a, f) : 0;
  for (int it = blockIdx.x, i = 0; it < a.items; it += G, ++i, ++fi, f += G) {
    if (f < a.items) fetch_item(fi, off_f);
    cp_async_commit();
    off_f = f + G < a.items ? offset_of(a, f + G) : 0;
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const int st = i % kStages;
    Item cur = item_at(a, it);
    cur.off = stage_off[st];
    float t[LMAX];
    const float4* t4 = reinterpret_cast<const float4*>(tap_ring + st * LMAX);
#pragma unroll
    for (int q = 0; q < LMAX / 4; ++q) {
      const float4 v = t4[q];
      t[4 * q] = v.x;
      t[4 * q + 1] = v.y;
      t[4 * q + 2] = v.z;
      t[4 * q + 3] = v.w;
    }
    float re[kR], im[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) re[r] = im[r] = 0.f;
    const float4* win = smem + st * stage;
    const int sh = (int)((window_addr(a, cur, sps) >> 3) & 1);
    if constexpr (SPS == 2) {
      if (sh) {
        fir2<LMAX, 1>(win, t, re, im);
      } else {
        fir2<LMAX, 0>(win, t, re, im);
      }
    } else {
      fir_any<LMAX>(win, sps, sh, t, re, im);
    }
#pragma unroll
    for (int p = 0; p < kR / 2; ++p) {
      outs[padded(kR / 2 * threadIdx.x + p)] =
          make_float4(re[2 * p], im[2 * p], re[2 * p + 1], im[2 * p + 1]);
    }
    __syncthreads();

    float2* yo = a.y + ((long long)cur.c * a.S + cur.s) * a.seg_len + cur.k0;
    if (((uintptr_t)yo & 15) == 0) {
      const int np = cur.cnt >> 1;
      float4* y4 = reinterpret_cast<float4*>(yo);
      for (int p = threadIdx.x; p < np; p += kThreads) y4[p] = outs[padded(p)];
      if ((cur.cnt & 1) && threadIdx.x == 0) {
        const float4 q = outs[padded(np)];
        yo[2 * np] = make_float2(q.x, q.y);
      }
    } else {
      const float2* o2 = reinterpret_cast<const float2*>(outs);
      for (int k = threadIdx.x; k < cur.cnt; k += kThreads) {
        yo[k] = o2[2 * padded(k >> 1) + (k & 1)];
      }
    }
  }
}

// blocks of one instantiation resident per SM, cached by shared-memory size
template <int SPS, int LMAX>
int blocks_per_sm(int smem) {
  static int cached_smem = -1, cached = 0, opted_in = 48 * 1024;
  if (smem == cached_smem) return cached;
  auto kernel = mf_segmented_kernel<SPS, LMAX>;
  if (smem > opted_in) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess) {
      return 0;
    }
    opted_in = smem;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  cached_smem = smem;
  cached = per_sm;
  return per_sm;
}

template <int SPS, int LMAX>
int grid_blocks(int sps) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return blocks_per_sm<SPS, LMAX>(smem_bytes(sps, LMAX)) * sms;
}

int grid_for(int L, int sps) {
  if (sps == 2) {
    return L <= 24 ? grid_blocks<2, 24>(sps) : grid_blocks<2, kMaxTaps>(sps);
  }
  return L <= 24 ? grid_blocks<0, 24>(sps) : grid_blocks<0, kMaxTaps>(sps);
}

template <int SPS, int LMAX>
int launch(const Args& a, int grid, cudaStream_t stream) {
  mf_segmented_kernel<SPS, LMAX><<<grid, kThreads, smem_bytes(a.sps, LMAX),
                                   stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mf_segmented_smem_bytes(int L, int sps) {
  return smem_bytes(sps, tap_bucket(L));
}

// persistent grid size (0 if the instantiation cannot be resident)
extern "C" int mf_segmented_grid_blocks(int L, int sps) {
  return grid_for(L, sps);
}

// start: null, or (C,) int32 block starts of `length` rows each
extern "C" int mf_segmented_launch(const void* x, const void* taps,
                                   const void* base, void* y, int C, int n,
                                   int S, int seg_len, int L, int sps,
                                   int off_bound, int chunk, int n_chunks,
                                   const void* start, int length,
                                   void* stream) {
  const long long items = (long long)C * S * n_chunks;
  if (start ? length < 1 || length > n : length != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (L < 1 || L > kMaxTaps || sps < 1 || C <= 0 || S <= 0 || seg_len <= 0 ||
      chunk < 1 || chunk > kChunkMax || (long long)n_chunks * chunk < seg_len ||
      (long long)(n_chunks - 1) * chunk >= seg_len || items >= (1LL << 31) ||
      smem_bytes(sps, tap_bucket(L)) > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = grid_for(L, sps);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const Args a{(const float2*)x, (const float*)taps, (const int*)base,
               (float2*)y, (const int*)start, n, S, seg_len, L, sps,
               off_bound, chunk, n_chunks, (int)items, length};
  const int grid = (int)(items < blocks ? items : blocks);
  cudaStream_t st = (cudaStream_t)stream;
  if (sps == 2) {
    return L <= 24 ? launch<2, 24>(a, grid, st)
                   : launch<2, kMaxTaps>(a, grid, st);
  }
  return L <= 24 ? launch<0, 24>(a, grid, st)
                 : launch<0, kMaxTaps>(a, grid, st);
}
