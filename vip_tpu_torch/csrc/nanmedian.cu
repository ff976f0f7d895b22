// H1: exact per-pixel median along the frame axis of an (n, h, w) float32
// cube, for Hopper (sm_90a).
//
// Replaces vip_tpu's Pallas TPU kernel `nanmedian_axis0`
// (vip_tpu/ops/pallas_median.py:66-127, body `_kernel`). Same semantics:
// NaNs are ignored and an all-NaN pixel gives NaN (propagate != 0: any NaN
// gives NaN); an even count averages the two middle values in float32.
//
// Keys (as the TPU kernel): each value maps to its order-preserving uint32
// key (negatives: ~bits; others: bits | 0x80000000; NaN: 0xFFFFFFFF, above
// every other key, +inf's 0xFF800000 included). The median is the key of
// rank r1 = (m-1)/2 + 1 (the lower middle of the m non-NaN values) and of
// rank r2 = m/2 + 1 (the upper middle; r2 = r1 when m is odd). Ranks count
// from the smallest key over all n keys: NaN keys, the largest, never hold
// a rank <= m, so they need no masking.
//
// What bounds it on this card: the cube is read once (4 B a value, 1.05 GB
// at 1000 x 512^2, 0.31 ms at 3.35 TB/s); everything after that is
// shared-memory work on the keys staged there, so the number of sweeps
// over the keys sets the cost. Two bodies, chosen by n alone
// (`vip_tpu_torch.ops.median.median_body`):
//
// Digit body, n <= 1650 (`nanmedian_digits_kernel`). A block holds 32
// pixels, one a lane, and 32 warps that split the frames (warp w takes
// frames w, w + 32, ...). It selects the keys of rank r1 and r2 by their
// four 8-bit digits, top digit first, with one 256-bin histogram a pixel:
//   - the load sweep copies the cube into shared memory with cp.async, in
//     rows of 32 consecutive pixels (128 B a warp), every copy of a thread
//     in flight at once, as keys[frame][pixel]; it turns the values into
//     keys there, counts the non-NaN ones and histograms the top digit;
//   - the second sweep histograms the second digit of the keys in r1's
//     top-digit bin and keeps those keys (the candidates) at the front of
//     each thread's slots; the third and fourth sweeps visit only the
//     candidates (about 1/8 of the keys of noise-like data), each
//     histogramming the next digit of those that share the digits chosen
//     so far;
//   - after each histogram, warp w scans bins 8w..8w+7 of every pixel
//     (their total, then the sum of the lower warps' totals), and the warp
//     whose bins hold rank r1 (r2) appends that bin to r1's (r2's) prefix
//     and keeps the rank left within it.
// While r1 and r2 share their prefix they are one selection. When they
// part (r2 = r1 + 1 and r1 the last key of its bin), r2's key is the
// smallest key of its own bin: its digits are all known when the parting
// histogram is the last one, and otherwise the next sweep takes that
// minimum (atomicMin) beside its histogram. So the cube is read once and
// the keys swept twice in full and twice over the candidates, against 34
// full sweeps for the bisection body; each sweep ends in a barrier, each
// scan in two. Shared memory: keys, 32 x n x 4 B (128 KB at n = 1000);
// the histograms, 16-bit counters two bins a word, word (bin / 2) * 32 +
// lane, so the 32 lanes of a warp increment 32 different words, one a
// bank, whatever their digits (n <= 1650 < 2^16: no carry between the
// halves); the warps' bin totals and the per-pixel selection state.
//
// Bisection body, 1650 < n <= 3600 (`nanmedian_axis0_kernel`). A block
// stages the keys of 16 pixels x n frames in shared memory (16 threads a
// pixel, each counting every 16th frame, partial counts meeting through
// shared memory): one sweep to count the NaNs, 32 rounds of MSB-first
// bisection of r1's key (one count of `key < candidate` each), then the
// upper middle in one more sweep: a duplicate of the lower one or the
// smallest key above it.
//
// Both bodies give the same keys, hence the same output bits. Bounds: n <=
// 3600 frames (a 16-pixel tile of keys within the 227 KB of shared memory
// a block may use) and h*w < 2^31 pixels. No --use_fast_math: denormals
// must not be flushed, or the result would differ bitwise from the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;  // shared memory a block may use

constexpr int TPX = 16;     // bisection body: pixels per block
constexpr int SLICES = 16;  // threads per pixel, splitting the frames

constexpr int DPX = 32;               // digit body: pixels per block
constexpr int DWARPS = 32;            // warps per block, splitting frames
constexpr int DBINS = 256;            // bins of an 8-bit digit
constexpr int DWORDS = DBINS / 2;     // 16-bit counters, two bins a word
constexpr int DCHUNK = DBINS / DWARPS;  // bins each warp scans
constexpr int DSTATE = 6;             // per-pixel state words (see below)

// shared memory of the digit body besides the keys, in uint32 words
constexpr int kDigitFixedWords =
    DWORDS * DPX + DWARPS * DPX + DSTATE * DPX;
constexpr int kDigitMaxFrames = (kSmemMax - 4 * kDigitFixedWords) / (4 * DPX);
// 227 KB less the partial counts, over a 16-pixel row of keys
constexpr int kMaxFrames = (kSmemMax - 2 * SLICES * TPX * 4) / (TPX * 4);
static_assert(kDigitMaxFrames == 1650, "ops/median.py: _DIGIT_MAX_FRAMES");
static_assert(kMaxFrames == 3600, "ops/median.py: _MAX_FRAMES");

constexpr uint32_t kNanKey = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t to_key(float x) {
  uint32_t u = __float_as_uint(x);
  if (isnan(x)) return kNanKey;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(u);
}

__device__ __forceinline__ float median_of(uint32_t k1, uint32_t k2, int m,
                                           int n, int propagate) {
  const bool bad = m == 0 || (propagate && m < n);
  return bad ? __uint_as_float(0x7FC00000u)
             : 0.5f * (from_key(k1) + from_key(k2));
}

// ---------------------------------------------------------------- digits

// Count one key's digit d in the lane's pixel histogram.
__device__ __forceinline__ void bump(uint32_t* hist, uint32_t d, int lane) {
  atomicAdd(hist + (d >> 1) * DPX + lane, 1u << ((d & 1) << 4));
}

// Copy 4 bytes from device memory to shared memory asynchronously
// (cp.async; nothing is read when `valid` is false, the slot then gets 0).
__device__ __forceinline__ void copy4(uint32_t* dst, const float* src,
                                      bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// In a warp's chunk of DCHUNK bin counts starting at cumulative count
// `base`, the bin that holds rank r (base < r <= base + chunk total), and
// the count below it.
__device__ __forceinline__ int find_bin(const uint32_t* cnt, uint32_t base,
                                        uint32_t r, uint32_t* below) {
  int d = 0;
  bool found = false;
  uint32_t acc = base;
#pragma unroll
  for (int j = 0; j < DCHUNK; ++j) {
    if (!found && acc + cnt[j] >= r) {
      d = j;
      *below = acc;
      found = true;
    }
    acc += cnt[j];
  }
  return d;
}

__global__ void __launch_bounds__(DPX* DWARPS)
    nanmedian_digits_kernel(const float* __restrict__ x,
                            float* __restrict__ out, int n, int npix,
                            int propagate) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;                        // [n][DPX]
  uint32_t* hist = keys + (size_t)n * DPX;      // [DWORDS][DPX]
  uint32_t* part = hist + DWORDS * DPX;         // [DWARPS][DPX] bin totals
  uint32_t* count = part + DWARPS * DPX;        // non-NaN values
  uint32_t* bin1 = count + DPX;                 // r1's bin, rank left in it
  uint32_t* rank1 = bin1 + DPX;
  uint32_t* bin2 = rank1 + DPX;                 // the same for r2
  uint32_t* rank2 = bin2 + DPX;
  uint32_t* min2 = rank2 + DPX;                 // smallest key of r2's bin
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * DPX + lane;
  const bool valid = p < npix;

  for (int i = threadIdx.x; i < DWORDS * DPX; i += blockDim.x) hist[i] = 0;
  if (w == 0) {
    count[lane] = 0;
    min2[lane] = kNanKey;
  }
  __syncthreads();

  // the load sweep: each thread copies its pixel's values of its frames
  // into its own key slots (cp.async, all of them in flight at once; a
  // pixel past the end copies nothing), then turns them into keys, counts
  // the non-NaN ones and histograms the top digit. A thread reads back only
  // what it copied itself, so no barrier stands between the two.
  const float* src = x + (valid ? p : 0);
  for (int i = w; i < n; i += DWARPS)
    copy4(keys + i * DPX + lane, src + (long long)i * npix, valid);
  asm volatile("cp.async.wait_all;" ::: "memory");
  uint32_t m = 0;
  for (int i = w; i < n; i += DWARPS) {
    uint32_t* slot = keys + i * DPX + lane;
    const uint32_t k = to_key(__uint_as_float(*slot));
    *slot = k;
    m += k != kNanKey;
    bump(hist, k >> 24, lane);
  }
  atomicAdd(count + lane, m);
  __syncthreads();
  const int mi = (int)count[lane];

  // ranks among the keys that share `pre` (m = 0: both 1, the output is
  // NaN anyway)
  uint32_t r1 = (uint32_t)((mi - 1) / 2 + 1);
  uint32_t r2 = (uint32_t)(mi / 2 + 1);
  uint32_t pre = 0;               // r1's digits chosen so far
  bool split = false;             // r2's key lies in another bin
  uint32_t pre2 = 0;              // that bin: keys with k >> sh2 == pre2
  int sh2 = 0;
  // the thread's keys sit in its slots (w + DWARPS * j, lane): its `nf`
  // frames, of which the second sweep keeps the `nc` of r1's top-digit bin
  // (candidates) in the first slots, in place (slot j is read before any
  // later candidate is written to it); the later sweeps visit only those.
  // They hold r1's later bins, and r2's bin when r2 parts from r1 after the
  // first histogram; when it parts at the first, the second sweep, which
  // visits every key, takes its minimum.
  const int nf = w < n ? (n - 1 - w) / DWARPS + 1 : 0;
  int nc = 0;
  for (int s = 24; s >= 0; s -= 8) {
    if (s < 24) {
      const bool take_min = split && sh2 == s + 8;
      const int visit = s == 16 ? nf : nc;
      for (int j = 0; j < visit; ++j) {
        const uint32_t k = keys[(w + j * DWARPS) * DPX + lane];
        if ((k >> (s + 8)) == pre) {
          bump(hist, (k >> s) & 255u, lane);
          if (s == 16) keys[(w + nc++ * DWARPS) * DPX + lane] = k;
        }
        if (take_min && (k >> sh2) == pre2) atomicMin(min2 + lane, k);
      }
      __syncthreads();
    }

    // warp w: its bins' counts (and clears them), their total
    uint32_t cnt[DCHUNK];
    uint32_t tot = 0;
#pragma unroll
    for (int j = 0; j < DCHUNK / 2; ++j) {
      uint32_t* word = hist + (w * (DCHUNK / 2) + j) * DPX + lane;
      const uint32_t h = *word;
      *word = 0;
      cnt[2 * j] = h & 0xFFFFu;
      cnt[2 * j + 1] = h >> 16;
      tot += cnt[2 * j] + cnt[2 * j + 1];
    }
    part[w * DPX + lane] = tot;
    __syncthreads();
    uint32_t base = 0;
#pragma unroll
    for (int j = 0; j < DWARPS; ++j)
      if (j < w) base += part[j * DPX + lane];
    uint32_t below = 0;
    if (base < r1 && r1 <= base + tot) {
      bin1[lane] = w * DCHUNK + find_bin(cnt, base, r1, &below);
      rank1[lane] = r1 - below;
    }
    if (!split && base < r2 && r2 <= base + tot) {
      bin2[lane] = w * DCHUNK + find_bin(cnt, base, r2, &below);
      rank2[lane] = r2 - below;
    }
    __syncthreads();
    const uint32_t d1 = bin1[lane];
    if (!split) {
      const uint32_t d2 = bin2[lane];
      r2 = rank2[lane];
      if (d2 != d1) {
        split = true;
        pre2 = (pre << 8) | d2;
        sh2 = s;
      }
    }
    pre = (pre << 8) | d1;
    r1 = rank1[lane];
  }

  if (w == 0 && valid) {
    const uint32_t k2 = !split ? pre : (sh2 == 0 ? pre2 : min2[lane]);
    out[p] = median_of(pre, k2, mi, n, propagate);
  }
}

// ------------------------------------------------------------- bisection

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
        valid ? to_key(__ldg(x + (long long)i * npix + p)) : kNanKey;
    keys[i * TPX + tx] = k;
    m += k != kNanKey;
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
  uint32_t gt_min = kNanKey;
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
    out[p] = median_of(prefix, le >= r2 ? prefix : gt_min, m, n, propagate);
  }
}

// The body n frames take, its block shape, dynamic shared memory and grid.
struct Config {
  const void* kernel;
  dim3 block;
  size_t smem;
  long long blocks;
};

Config config(long long n, long long npix) {
  if (n <= kDigitMaxFrames)
    return {(const void*)nanmedian_digits_kernel, dim3(DPX * DWARPS),
            ((size_t)n * DPX + kDigitFixedWords) * sizeof(uint32_t),
            (npix + DPX - 1) / DPX};
  return {(const void*)nanmedian_axis0_kernel, dim3(TPX, SLICES),
          ((size_t)n + 2 * SLICES) * TPX * sizeof(uint32_t),
          (npix + TPX - 1) / TPX};
}

}  // namespace

extern "C" int vip_nanmedian_axis0(const float* x, float* out, long long n,
                                   long long npix, int propagate,
                                   void* stream) {
  if (n < 1 || n > kMaxFrames || npix < 1 || npix >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Config c = config(n, npix);
  cudaError_t err = cudaFuncSetAttribute(
      c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  int ni = (int)n, np = (int)npix;
  void* args[] = {(void*)&x, (void*)&out, (void*)&ni, (void*)&np,
                  (void*)&propagate};
  err = cudaLaunchKernel(c.kernel, dim3((unsigned)c.blocks), c.block, args,
                         c.smem, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// H1's configuration for n frames, without a launch: info[0..5] =
// registers a thread, spilled (local) bytes a thread, blocks an SM,
// threads a block, dynamic shared memory a block, and the body (1: digits,
// 0: bisection). Returns a CUDA error code.
extern "C" int vip_nanmedian_info(long long n, int* info) {
  if (n < 1 || n > kMaxFrames || info == nullptr)
    return (int)cudaErrorInvalidValue;
  const Config c = config(n, 1);
  cudaError_t err = cudaFuncSetAttribute(
      c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (int)(c.block.x * c.block.y);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, c.kernel,
                                                      threads, c.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, c.kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = per_sm;
  info[3] = threads;
  info[4] = (int)c.smem;
  info[5] = n <= kDigitMaxFrames ? 1 : 0;
  return 0;
}

extern "C" const char* vip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
