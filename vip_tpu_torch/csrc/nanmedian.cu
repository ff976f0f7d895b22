// H1: exact per-pixel median along the frame axis of an (n, h, w) float32
// cube, for Hopper (sm_90a).
//
// Replaces vip_tpu's Pallas TPU kernel `nanmedian_axis0`
// (vip_tpu/ops/pallas_median.py:66-127, body `_kernel`). Same semantics:
// NaNs are ignored and an all-NaN pixel gives NaN (propagate != 0: any NaN
// gives NaN); an even count averages the two middle values in float32.
//
// Algorithm (as the TPU kernel): map each value to the order-preserving
// uint32 key (negatives: ~bits; others: bits | 0x80000000; NaN: 0xFFFFFFFF),
// find the key of the lower middle (rank r1 = (m-1)/2 + 1 of the m non-NaN
// values) by 32 rounds of MSB-first bisection, each round one count of
// `key < candidate` over the n frames, then the upper middle in one more
// pass: either a duplicate of the lower one or the smallest key above it.
//
// What bounds it on this card: the 34 passes over the frames (one NaN
// count, 32 rounds, one final pass). Streamed from device memory they move
// 34x the cube (34 GB for 1000x512x512, which does not fit the 50 MB L2).
// So a block stages the keys of a tile of TPX pixels x n frames in shared
// memory once (the only device-memory read of the cube) and runs all
// passes there: SLICES threads share a pixel, each counting every
// SLICES-th frame, and the partial counts meet in shared memory with one
// barrier per pass. Consecutive threads take consecutive pixels, so both
// the tile load and the shared-memory reads are conflict-free rows.
//
// Bounds of this kernel: n <= 3600 frames (n * TPX * 4 B of keys plus the
// partial counts within the 227 KB of shared memory a block may use) and
// h*w < 2^31 pixels. No --use_fast_math: denormals must not be flushed, or
// the result would differ bitwise from the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPX = 16;     // pixels per block
constexpr int SLICES = 16;  // threads per pixel, splitting the frames

__device__ __forceinline__ uint32_t to_key(float x) {
  uint32_t u = __float_as_uint(x);
  if (isnan(x)) return 0xFFFFFFFFu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(u);
}

// Sum of `v` over the SLICES threads of each pixel, through one of two
// alternating partial-count buffers (so one barrier per reduction does).
__device__ __forceinline__ int slice_sum(uint32_t* part, int v, int& buf) {
  uint32_t* p = part + buf * SLICES * TPX;
  p[threadIdx.y * TPX + threadIdx.x] = (uint32_t)v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int j = 0; j < SLICES; ++j) s += (int)p[j * TPX + threadIdx.x];
  buf ^= 1;
  return s;
}

__global__ void nanmedian_axis0_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int n,
                                       int npix, int propagate) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;                          // [n][TPX]
  uint32_t* part = smem + (size_t)n * TPX;        // [2][SLICES][TPX]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int p = blockIdx.x * TPX + tx;
  const bool valid = p < npix;
  int buf = 0;

  // stage the tile's keys (the one device-memory read) and count non-NaN
  int m = 0;
#pragma unroll 8
  for (int i = ty; i < n; i += SLICES) {
    const uint32_t k =
        valid ? to_key(__ldg(x + (long long)i * npix + p)) : 0xFFFFFFFFu;
    keys[i * TPX + tx] = k;
    m += k != 0xFFFFFFFFu;
  }
  m = slice_sum(part, m, buf);
  const int r1 = (m - 1) / 2 + 1;  // lower middle rank (1-based)
  const int r2 = m / 2 + 1;        // upper middle rank

  // invariant: prefix <= key_r1 < prefix + 2*bit
  uint32_t prefix = 0;
  for (int b = 31; b >= 0; --b) {
    const uint32_t cand = prefix | (1u << b);
    int lt = 0;
    for (int i = ty; i < n; i += SLICES) lt += keys[i * TPX + tx] < cand;
    if (slice_sum(part, lt, buf) < r1) prefix = cand;
  }

  int le = 0;
  uint32_t gt_min = 0xFFFFFFFFu;
  for (int i = ty; i < n; i += SLICES) {
    const uint32_t k = keys[i * TPX + tx];
    le += k <= prefix;
    if (k > prefix && k < gt_min) gt_min = k;
  }
  le = slice_sum(part, le, buf);
  uint32_t* q = part + buf * SLICES * TPX;
  q[ty * TPX + tx] = gt_min;
  __syncthreads();
  if (ty == 0 && valid) {
#pragma unroll
    for (int j = 1; j < SLICES; ++j) gt_min = min(gt_min, q[j * TPX + tx]);
    const float v1 = from_key(prefix);
    const float v2 = le >= r2 ? v1 : from_key(gt_min);
    const bool bad = m == 0 || (propagate && m < n);
    out[p] = bad ? __uint_as_float(0x7FC00000u) : 0.5f * (v1 + v2);
  }
}

}  // namespace

// 227 KB of shared memory a block may use, less the partial counts
constexpr int MAX_FRAMES = (232448 - 2 * SLICES * TPX * 4) / (TPX * 4);

extern "C" int vip_nanmedian_axis0(const float* x, float* out, long long n,
                                   long long npix, int propagate,
                                   void* stream) {
  if (n < 1 || n > MAX_FRAMES) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)n + 2 * SLICES) * TPX * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      nanmedian_axis0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (npix + TPX - 1) / TPX;
  nanmedian_axis0_kernel<<<(unsigned)blocks, dim3(TPX, SLICES), smem,
                           (cudaStream_t)stream>>>(x, out, (int)n, (int)npix,
                                                   propagate);
  return (int)cudaGetLastError();
}

extern "C" const char* vip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
