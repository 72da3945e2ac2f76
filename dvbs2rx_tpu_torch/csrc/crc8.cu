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
// CRC-8 with init 0, no reflection and no final XOR: leading zero bytes
// leave it unchanged, so every window is W bytes long once the row is
// preceded by W zero bytes, as the plain version's zero-filling shifts
// have it (ok[0] tests bytes[0] == 0). ok is packed LSB-first into
// ceil(n/8) bytes per row, pad bits 0.
//
// Design: one block of 256 threads per frame, each thread a run of 32
// consecutive positions (one 32-bit word of the packed map). The row sits
// in shared memory behind W zero bytes, padded by one word every 32 bytes so
// that the threads of a warp, 32 bytes apart, read 32 different banks. A
// thread computes its first window's CRC byte by byte (W table steps), then
// slides: crc(b[p-W+1 .. p]) = T[crc(b[p-W .. p-1]) ^ b[p]] ^ Z[b[p-W]],
// where Z[x] is the CRC of x followed by W zero bytes (the outgoing byte's
// share, CRC-8 being linear); T and Z come from the wrapper. What bounds
// it: the chain of W + 32 dependent shared-memory table reads of a thread
// (~7 us at ~30 cycles each), far above the bytes (B n in, B n / 8 out) and
// the ~2 table reads per position that the sliding form needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;                  // positions per thread
constexpr int kMaxN = kThreads * kRun;    // bytes per row
constexpr int kMaxWindow = 255;

__device__ __forceinline__ int slot(int q) { return q + ((q >> 5) << 2); }

constexpr int kBufBytes = kMaxWindow + kMaxN + ((kMaxWindow + kMaxN) >> 5) * 4
                          + 4;

__global__ void __launch_bounds__(kThreads)
crc8_validity_kernel(const uint8_t* __restrict__ frames,
                     const uint8_t* __restrict__ tables,
                     uint8_t* __restrict__ ok, int* __restrict__ hdr_ok,
                     int n, int n_packed, int window) {
  __shared__ uint8_t buf[kBufBytes];
  __shared__ unsigned T[256], Z[256];
  const int f = blockIdx.x, tid = threadIdx.x;
  const uint8_t* row = frames + (long long)f * n;
  T[tid] = tables[tid];
  Z[tid] = tables[256 + tid];
  // buffer index q' = q + window for frame byte q; zeros before and after
  for (int q = tid; q < window + kMaxN; q += kThreads) {
    const int src = q - window;
    buf[slot(q)] = (src >= 0 && src < n) ? row[src] : 0;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned rem = 0;
    for (int k = 0; k < 9; ++k) rem = T[rem ^ buf[slot(window + k)]];
    hdr_ok[f] = rem == buf[slot(window + 9)];
  }
  const int p0 = tid * kRun;
  if (p0 >= n) return;
  unsigned rem = 0;                       // crc of bytes p0 - window .. p0 - 1
  for (int k = 0; k < window; ++k) rem = T[rem ^ buf[slot(p0 + k)]];
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int p = p0 + j;
    const unsigned x = buf[slot(p + window)];
    if (p < n && rem == x) bits |= 1u << j;
    rem = T[rem ^ x] ^ Z[buf[slot(p)]];
  }
  uint8_t* dst = ok + (long long)f * n_packed + p0 / 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (p0 / 8 + k < n_packed) dst[k] = (uint8_t)(bits >> (8 * k));
  }
}

}  // namespace

extern "C" int crc8_validity_launch(const void* frames, const void* tables,
                                    void* ok, void* hdr_ok, int B, int n,
                                    int n_packed, int window, void* stream) {
  if (B <= 0 || n < 10 || n > kMaxN || n_packed != (n + 7) / 8 ||
      window < 1 || window > kMaxWindow) {
    return (int)cudaErrorInvalidValue;
  }
  crc8_validity_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const uint8_t*)tables, (uint8_t*)ok,
      (int*)hdr_ok, n, n_packed, window);
  return (int)cudaGetLastError();
}
