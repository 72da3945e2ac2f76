// Layered offset-min-sum LDPC decoder for DVB-S2 quasi-cyclic codes, with
// the check messages held on chip in compressed form.
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
//   * iteration 0 treats the old messages as 0;
//   * layer 0 has no previous-parity edge at check row 0: its value is 127
//     in both the update and the parity check, its message and delta 0;
//   * the parity check runs before the first iteration and after each one
//     (a zero LLR counts as unsatisfied) and stops the frame's decode.
//
// Layout: one CTA per frame (the per-lane freeze of the JAX kernel makes
// every frame independent of its batch; B = 128 fills one wave of the
// H100's 132 SMs), one thread per check row (360 rows in 12 warps). The
// frame's variables -- data blocks v[b][m] at b*360 + m, parity rows
// p[i][m] at K + i*360 + m -- sit in dynamic shared memory, and the TPU
// kernel's cyclic rolls are index arithmetic: roll(v[b], s)[r] =
// v[b][(r - s) mod 360].
//
// What bounds it on this card: integer operations. Counted as int32
// lane-instructions, with Hopper's fused add+min/max (VIADDMNMX) as one,
// an edge update is 17 (old message 3, input 2, magnitude 3, minimum scan
// 4, sign 1, write-back 4) and a parity-check term 3 (xor, abs, min), so
// S2_B4 (226,800 edges a frame) needs ~3.9 M per frame and iteration: at
// 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s, ~30 us for 128 frames.
// Only a passing parity check must visit every check; a failing one may
// stop at its first unsatisfied check. The bytes are small beside it: 3 x
// 8.3 MB of LLRs in and out at B = 128, ~7.4 us at 3.35 TB/s. One frame
// per SM leaves each warp scheduler three warps, so latency (shared-memory
// loads, dependent integer chains, barriers) is what the design has to
// hide:
//
//   * check messages never leave the SM. A (layer, row) keeps one word:
//     min(min0, 32) and min(min1, 32) in 6 bits each, idx0 (the first edge
//     that reaches min0) in log2(KE) bits and the E output signs, edge c at
//     bit c (data edges, then own and previous parity). The stored message
//     of edge c is clip(+-(c == idx0 ? min1 : min0), -32, 31): a tie at
//     min0 gives min1 == min0, so this is exact (layout and proof: ops/
//     ldpc.py pack_layer_msgs). Codes with at most KE = 8, 16, 32 edges per
//     check take 3 bytes (a u16 and a u8 plane), 4 or 8 bytes a word; every
//     DVB-S2/S2X table fits beside its N-byte frame (S2_B4: 97,200 + 64,800
//     B; the largest, S2X_B1: 151,200 + 64,800 B);
//   * no local memory and no branch per edge: the kernel is a template on
//     the code's largest data degree DM (and whether its layers differ), so
//     every edge loop unrolls, each row's edge values stay in registers and
//     all of a layer's shared-memory loads issue back to back. The first
//     minimum, its index and the second minimum come from one running
//     min/max over keys mag * 32 + c; signs pack with one funnel shift
//     each. The edge tables (base and shift per edge, per-layer barrier
//     masks) are loaded into shared memory once per CTA. The shapes are
//     exact: on S2_B4 (data degree 5, every layer alike) a mask for layers
//     short of DM made the decode 12% slower, and a DM bucket one edge wider
//     (6) 20% (tools/torch_kernel_ab.py on an H100);
//   * one barrier per layer: in a layer that names no block twice every
//     variable is touched by exactly one (row, edge), so only the 8 such
//     layers of S2_B4 keep the barrier between the read and write phases
//     and the ordered write-back;
//   * the parity check stays a separate pass over shared memory (an XOR
//     and a minimum |value| per row, each row stopping at its first
//     unsatisfied check), its stop test one __syncthreads_or;
//   * the frame moves between device and shared memory in 8-byte words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 360;           // check rows per layer (DVB-S2 M)
constexpr int kThreads = 384;     // 12 warps; rows 360..383 idle
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kBig = 0x7fffffff;  // key of an edge slot the layer lacks

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The message word of one (layer, row): bits 0-5 min(min0, 32), 6-11
// min(min1, 32), then kIB bits of idx0, then one output sign per edge.
template <int KE>
struct MsgWord;

template <>
struct MsgWord<8> {               // 23 bits: a u16 plane and a u8 plane
  using T = uint32_t;
  static constexpr int kIB = 3, kBytes = 3;
  __device__ static T load(const uint8_t* st, int nw, int k) {
    return (T)((const uint16_t*)st)[k] | ((T)st[2 * nw + k] << 16);
  }
  __device__ static void store(uint8_t* st, int nw, int k, T w) {
    ((uint16_t*)st)[k] = (uint16_t)w;
    st[2 * nw + k] = (uint8_t)(w >> 16);
  }
};

template <>
struct MsgWord<16> {              // 32 bits
  using T = uint32_t;
  static constexpr int kIB = 4, kBytes = 4;
  __device__ static T load(const uint8_t* st, int, int k) {
    return ((const uint32_t*)st)[k];
  }
  __device__ static void store(uint8_t* st, int, int k, T w) {
    ((uint32_t*)st)[k] = w;
  }
};

template <>
struct MsgWord<32> {              // 49 bits
  using T = uint64_t;
  static constexpr int kIB = 5, kBytes = 8;
  __device__ static T load(const uint8_t* st, int, int k) {
    return ((const uint64_t*)st)[k];
  }
  __device__ static void store(uint8_t* st, int, int k, T w) {
    ((uint64_t*)st)[k] = w;
  }
};

__host__ __device__ constexpr int word_bucket(int edges) {
  return edges <= 8 ? 8 : edges <= 16 ? 16 : 32;
}

__host__ __device__ constexpr int msg_bytes(int ke) {
  return ke == 8 ? 3 : ke == 16 ? 4 : 8;
}

// Shared-memory tables (ops/ldpc_cuda.py packed_tables): per layer info[i]
// = e0 | D << 16 | lsync << 24 and sync[i] (bit c: barrier before data
// edge c); per data edge base | shift << 16, padded with DM entries.
__host__ __device__ constexpr int table_ints(int q, int n_edges, int dm) {
  return (2 * q + n_edges + dm + 3) & ~3;           // 16-byte multiple
}

// Variable index of a data edge at check row r: base + (r - shift) mod 360.
__device__ __forceinline__ int edge_addr(int t, int r) {
  const unsigned m = (unsigned)(r - (t >> 16));
  return (t & 0xFFFF) + (int)min(m, m + kM);
}

// Old message of an edge, negated: -clip(+-(c == ix ? m1 : m0), -32, 31),
// from the candidates q0 = {-min(m0, 31), m0}, q1 = {-min(m1, 31), m1}.
__device__ __forceinline__ int neg_old(bool neg, bool is_ix, int q0p,
                                       int q0n, int q1p, int q1n) {
  const int o0 = neg ? q0n : q0p;
  const int o1 = neg ? q1n : q1p;
  return is_ix ? o1 : o0;
}

// Input x of an edge and its scan key: mag * 32 + index.
__device__ __forceinline__ int edge_key(int v, int nold, int index, int& x) {
  x = clampi(v + nold, -128, 127);
  // mag = max(min(|x|, 127) - 1, 0) = clamp(|x|, 1, 127) - 1
  return clampi(abs(x), 1, 127) * 32 + index - 32;
}

// Running first and second smallest keys (k0 < k1, ties broken by index).
__device__ __forceinline__ void scan_key(int key, int& k0, int& k1) {
  k1 = min(k1, max(k0, key));
  k0 = min(k0, key);
}

// Block-wide parity check: true when any check of the frame is unsatisfied.
// A row stops at its first unsatisfied check.
template <int DM, bool VAR>
__device__ __forceinline__ bool frame_bad(const int8_t* s, const int* tab,
                                          int K, int q) {
  const int r = threadIdx.x;
  int bad = 0;
  if (r < kM) {
    for (int i = 0; i < q && !bad; ++i) {
      const int li = tab[i];
      const int* et = tab + 2 * q + (li & 0xFFFF);
      const int D = (li >> 16) & 0xFF;
      int v[DM];
#pragma unroll
      for (int c = 0; c < DM; ++c) v[c] = s[edge_addr(et[c], r)];
      const int pv = s[K + i * kM + r];
      int qv = s[i > 0 ? K + (i - 1) * kM + r : K + (q - 1) * kM + r - 1];
      if (i == 0 && r == 0) qv = 127;            // the dead edge
      int acc = pv ^ qv;                         // sign bit: parity
      int mn = min(abs(pv), abs(qv));            // 0: a zero LLR
#pragma unroll
      for (int c = 0; c < DM; ++c) {
        const int w = (VAR && c >= D) ? 1 : v[c];
        acc ^= w;
        mn = min(mn, abs(w));
      }
      bad |= (acc < 0) | (mn == 0);
    }
  }
  return __syncthreads_or(bad) != 0;
}

template <int DM, bool VAR>
__global__ void __launch_bounds__(kThreads, 1) ldpc_layered_kernel(
    const int8_t* __restrict__ llr_in,   // (B, N)
    int8_t* __restrict__ llr_out,        // (B, N)
    uint8_t* __restrict__ hard,          // (B, N)
    int* __restrict__ iters,             // (B,)
    int* __restrict__ conv,              // (B,)
    const int* __restrict__ tab_g,       // packed tables
    int N, int K, int q, int n_edges, int max_trials) {
  constexpr int KE = word_bucket(DM + 2);
  using W = MsgWord<KE>;
  using T = typename W::T;
  constexpr int kSB = 12 + W::kIB;       // first sign bit of the word
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = q * kM;
  const int n_tab = table_ints(q, n_edges, DM);
  uint8_t* mst = smem;                                     // message words
  int* tab = (int*)(smem + (size_t)nw * W::kBytes);        // tables
  int8_t* s = (int8_t*)(tab + n_tab);                      // frame state
  const int f = blockIdx.x;
  const int r = threadIdx.x;
  const bool act = r < kM;

  // frame in: data bits as they are, parity LLR K + j to p[j % q][j / q]
  for (int n = r; n < n_tab; n += kThreads) tab[n] = tab_g[n];
  const uint2* in8 = (const uint2*)(llr_in + (size_t)f * N);
#pragma unroll 4
  for (int n = r; n < N / 8; n += kThreads) {
    const uint2 w = in8[n];
    if (8 * n < K) {
      ((uint2*)s)[n] = w;
    } else {
      const int8_t* b = (const int8_t*)&w;
      int j = 8 * n - K, i = j % q, m = j / q;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[K + i * kM + m] = b[k];
        if (++i == q) {
          i = 0;
          ++m;
        }
      }
    }
  }
  __syncthreads();

  bool bad = frame_bad<DM, VAR>(s, tab, K, q);
  int it = 0;
  while (bad && it < max_trials) {
    for (int i = 0; i < q; ++i) {
      const int li = tab[i];
      const int* et = tab + 2 * q + (li & 0xFFFF);
      const int D = (li >> 16) & 0xFF;
      const bool lsync = (li >> 24) & 1;
      const bool dead = (i == 0 && r == 0);   // no previous-parity edge
      int a[DM], v[DM], x[DM];
      int pa = 0, px = 0, qa = 0, qx = 0;
      int k0 = kBig, k1 = kBig;
      uint32_t negs = 0;
      if (act) {
        // read phase: every edge value before any write of this layer
#pragma unroll
        for (int c = 0; c < DM; ++c) a[c] = edge_addr(et[c], r);
        pa = K + i * kM + r;
        qa = i > 0 ? K + (i - 1) * kM + r : K + (q - 1) * kM + r - 1;
#pragma unroll
        for (int c = 0; c < DM; ++c) v[c] = s[a[c]];
        const int pv = s[pa];
        const int qv = dead ? 127 : s[qa];
        const T w = it > 0 ? W::load(mst, nw, i * kM + r) : (T)0;
        const int m0 = (int)(w & 63), m1 = (int)((w >> 6) & 63);
        const int ix = (int)((w >> 12) & (KE - 1));
        const uint32_t sg = (uint32_t)(w >> kSB);
        const int q0p = -min(m0, 31), q1p = -min(m1, 31);
        // data edges, last to first, so edge c's sign lands at bit c
#pragma unroll
        for (int c = DM - 1; c >= 0; --c) {
          const int nold = neg_old((sg >> c) & 1, c == ix, q0p, m0, q1p, m1);
          const int key = edge_key(v[c], nold, c, x[c]);
          scan_key((VAR && c >= D) ? kBig : key, k0, k1);
          negs = __funnelshift_l((uint32_t)x[c], negs, 1);
        }
        const int pkey = edge_key(
            pv, neg_old((sg >> D) & 1, D == ix, q0p, m0, q1p, m1), D, px);
        int qkey = 0;
        if (dead) {                      // input 127, old message 0
          qkey = edge_key(127, 0, D + 1, qx);
        } else {
          qkey = edge_key(qv,
                          neg_old((sg >> (D + 1)) & 1, D + 1 == ix, q0p, m0,
                                  q1p, m1),
                          D + 1, qx);
        }
        scan_key(pkey, k0, k1);
        scan_key(qkey, k0, k1);
        if (VAR) negs &= (1u << D) - 1;
        negs |= ((uint32_t)px >> 31) << D | ((uint32_t)qx >> 31) << (D + 1);
      }
      const int min0 = k0 >> 5, idx0 = k0 & 31, min1 = k1 >> 5;
      // output sign of edge c: XOR of the other edges' signs
      const uint32_t outs =
          (negs ^ ((__popc(negs) & 1) ? 0xFFFFFFFFu : 0u)) &
          (0xFFFFFFFFu >> (30 - D));
      if (!lsync) {
        // no block named twice: each variable has this one writer, and it
        // still holds the value read above
        if (act) {
#pragma unroll
          for (int c = 0; c < DM; ++c) {
            const bool neg = (outs >> c) & 1;
            const int e = (c == idx0) ? min1 : min0;
            const int y = clampi(x[c] + (neg ? -e : e), -128, 127);
            if (!VAR || c < D) s[a[c]] = (int8_t)y;
          }
        }
      } else {
        __syncthreads();
        const int smask = tab[q + i];
        // write phase, edge by edge in edge order, barrier before a block
        // an earlier edge of the layer wrote
#pragma unroll
        for (int c = 0; c < DM; ++c) {
          if (!VAR || c < D) {
            if ((smask >> c) & 1) __syncthreads();
            if (act) {
              const bool neg = (outs >> c) & 1;
              const int e = (c == idx0) ? min1 : min0;
              const int y = clampi(x[c] + (neg ? -e : e), -128, 127);
              s[a[c]] = (int8_t)clampi(s[a[c]] + y - v[c], -128, 127);
            }
          }
        }
      }
      if (act) {
        // parity rows are touched by no data edge and by one row each
        int e = (D == idx0) ? min1 : min0;
        s[pa] = (int8_t)clampi(px + (((outs >> D) & 1) ? -e : e), -128, 127);
        if (!dead) {
          e = (D + 1 == idx0) ? min1 : min0;
          s[qa] = (int8_t)clampi(qx + (((outs >> (D + 1)) & 1) ? -e : e),
                                 -128, 127);
        }
        W::store(mst, nw, i * kM + r,
                 (T)min(min0, 32) | ((T)min(min1, 32) << 6) |
                     ((T)idx0 << 12) | ((T)outs << kSB));
      }
      __syncthreads();
    }
    ++it;
    bad = frame_bad<DM, VAR>(s, tab, K, q);
  }

  // frame out: LLRs and hard bits (LLR < 0), in the input's order
  uint2* out8 = (uint2*)(llr_out + (size_t)f * N);
  uint2* hard8 = (uint2*)(hard + (size_t)f * N);
#pragma unroll 4
  for (int n = r; n < N / 8; n += kThreads) {
    uint2 w;
    if (8 * n < K) {
      w = ((const uint2*)s)[n];
    } else {
      int8_t* b = (int8_t*)&w;
      int j = 8 * n - K, i = j % q, m = j / q;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        b[k] = s[K + i * kM + m];
        if (++i == q) {
          i = 0;
          ++m;
        }
      }
    }
    out8[n] = w;
    hard8[n] = make_uint2((w.x >> 7) & 0x01010101u, (w.y >> 7) & 0x01010101u);
  }
  if (r == 0) {
    iters[f] = it;
    conv[f] = !bad;
  }
}

template <int DM, bool VAR>
int launch(const void* llr_in, void* llr_out, void* hard, void* iters,
           void* conv, const void* tab, int B, int N, int K, int q,
           int n_edges, int max_trials, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ldpc_layered_kernel<DM, VAR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ldpc_layered_kernel<DM, VAR><<<B, kThreads, smem, stream>>>(
      (const int8_t*)llr_in, (int8_t*)llr_out, (uint8_t*)hard, (int*)iters,
      (int*)conv, (const int*)tab, N, K, q, n_edges, max_trials);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA in bytes (-1: the code does not fit).
extern "C" int ldpc_layered_smem_bytes(int N, int q, int n_edges, int dm) {
  if (dm < 1 || dm > 30) return -1;
  const long long b = (long long)q * kM * msg_bytes(word_bucket(dm + 2)) +
                      4LL * table_ints(q, n_edges, dm) + N;
  return b <= kMaxSmem ? (int)b : -1;
}

// The (DM, VAR) pairs of the repository's code tables (every table of
// available_tables(); tests/test_torch_ldpc.py fails for a table whose pair
// is missing here); another pair returns cudaErrorInvalidValue.
#define LDPC_CODE_SHAPES(X)                                               \
  X(2, false) X(2, true) X(3, false) X(3, true) X(4, false) X(5, false)   \
  X(5, true) X(6, true) X(7, false) X(7, true) X(8, false) X(8, true)     \
  X(9, false) X(9, true) X(10, true) X(11, false) X(11, true)             \
  X(12, false) X(12, true) X(13, true) X(14, true) X(15, true)            \
  X(16, false) X(17, true) X(18, true) X(20, false) X(25, false)          \
  X(28, false) X(28, true)

extern "C" int ldpc_layered_launch(const void* llr_in, void* llr_out,
                                   void* hard, void* iters, void* conv,
                                   const void* tab, int B, int N, int K,
                                   int q, int n_edges, int dm, int var,
                                   int max_trials, void* stream) {
  const int smem = ldpc_layered_smem_bytes(N, q, n_edges, dm);
  if (B <= 0 || q < 2 || N - K != q * kM || N % 8 || K % 8 ||
      K >= (1 << 16) || n_edges >= (1 << 16) || smem < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
#define LDPC_CASE(D_, V_)                                                 \
  if (dm == D_ && (var != 0) == V_)                                       \
    return launch<D_, V_>(llr_in, llr_out, hard, iters, conv, tab, B, N,  \
                          K, q, n_edges, max_trials, smem, st);
  LDPC_CODE_SHAPES(LDPC_CASE)
#undef LDPC_CASE
  return (int)cudaErrorInvalidValue;
}
