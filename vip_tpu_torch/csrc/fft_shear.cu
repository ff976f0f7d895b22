// H2: one FFT shear of VIP's exact 4x-padded three-shear rotation, for
// Hopper (sm_90a). Three launches (x-shear, y-shear, x-shear) rotate a batch
// of frames; vip_tpu_torch/ops/shear.py drives them.
//
// Replaces vip_tpu's Pallas TPU kernel `rotate_fft_exact_fused`
// (vip_tpu/ops/pallas_shear.py:550-613, through `_shear_x` :442-494 /
// `_shear_rows_body` :214-271 and `_shear_y` :497-544 /
// `_shear_cols_body` :298-353). It computes what those compute, not how:
// the TPU kernel's 128-lane fold, bf16 hi/lo splits and matmul DFT are not
// carried over.
//
// One thread block shears one line (a row for the x-shears, a column for
// the y-shear) of a canvas of N points, N a power of two, 128 <= N <= 4096:
//   1. load the line's occupied band (in_len values at canvas offset
//      in_off, real or complex) into shared memory as complex64, zeros
//      elsewhere: the 4x canvas never exists in device memory;
//   2. radix-2 decimation-in-frequency FFT in place (natural order in,
//      bit-reversed out);
//   3. multiply bin p by exp(-2*pi*i * c * (q - N/2) * k / N), where k is
//      the signed frequency of bit-reversed position p (k >= N/2 -> k - N,
//      so -N/2 sits at index N/2 as in numpy's fftfreq), q the canvas
//      coordinate of the line and c the frame's shear coefficient (float64,
//      as the plain version takes it). c*(q-N/2)*k/N reaches ~360 cycles
//      at N = 2048, where float32 loses ~1e-4 rad: the cycle count is
//      formed in float64 (exact integer (q-N/2)*k times c), reduced to
//      [-1/2, 1/2] in float64, and only then evaluated with sincospif in
//      float32;
//   4. radix-2 decimation-in-time inverse FFT (bit-reversed in, natural
//      out) with conjugate twiddles, scaled by 1/N at the store;
//   5. store only the output band (out_len points at canvas offset
//      out_off), complex or its real part.
// Twiddles exp(-2*pi*i*t/N), t < N/2, are built on the host in float64 and
// read as float32 through the read-only cache.
//
// What bounds it on this card: shared-memory traffic and barriers. Each
// radix-2 stage reads and writes the whole line in shared memory and ends
// in __syncthreads (2*log2(N) = 22 stages at N = 2048); the device-memory
// traffic is the compact bands between shears (~60 MB per 512^2 frame).
// The y-shear reads and writes columns with a row stride, so its loads
// use a quarter of each 32-byte sector. Next steps, for later: radix-4/8
// stages in registers, several columns per block for coalesced y-shear
// loads, and fusing the three shears.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <bool REAL_IN, bool REAL_OUT>
__global__ void shear_lines_kernel(
    const void* __restrict__ in_ptr, void* __restrict__ out_ptr,
    const double* __restrict__ coef, const float2* __restrict__ tw,
    int lines, int N, int logN, int q0,
    long long in_sb, long long in_sl, long long in_si, int in_len, int in_off,
    long long out_sb, long long out_sl, long long out_si, int out_len,
    int out_off) {
  extern __shared__ float2 buf[];
  const int line = blockIdx.x % lines;
  const int b = blockIdx.x / lines;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int half_n = N >> 1;

  // 1. load the occupied band, zeros elsewhere
  const long long ibase = (long long)b * in_sb + (long long)line * in_sl;
  for (int i = tid; i < N; i += nt) {
    const int j = i - in_off;
    float2 v = make_float2(0.f, 0.f);
    if (j >= 0 && j < in_len) {
      if (REAL_IN) {
        v.x = __ldg(static_cast<const float*>(in_ptr) + ibase + j * in_si);
      } else {
        v = __ldg(static_cast<const float2*>(in_ptr) + ibase + j * in_si);
      }
    }
    buf[i] = v;
  }
  __syncthreads();

  // 2. forward DIF: natural in, bit-reversed out
  for (int half = half_n; half >= 1; half >>= 1) {
    const int tstride = half_n / half;
    for (int j = tid; j < half_n; j += nt) {
      const int pos = j & (half - 1);
      const int i0 = ((j & ~(half - 1)) << 1) | pos;
      const int i1 = i0 + half;
      const float2 a = buf[i0];
      const float2 c = buf[i1];
      buf[i0] = make_float2(a.x + c.x, a.y + c.y);
      buf[i1] = cmul(make_float2(a.x - c.x, a.y - c.y), __ldg(tw + pos * tstride));
    }
    __syncthreads();
  }

  // 3. shear phase on the bit-reversed spectrum
  const double cq = coef[b] * (double)(q0 + line - half_n);
  for (int p = tid; p < N; p += nt) {
    int k = (int)(__brev((unsigned)p) >> (32 - logN));
    if (k >= half_n) k -= N;
    double cyc = cq * (double)k / (double)N;
    cyc -= rint(cyc);
    float s, c;
    sincospif(-2.0f * (float)cyc, &s, &c);
    buf[p] = cmul(buf[p], make_float2(c, s));
  }
  __syncthreads();

  // 4. inverse DIT: bit-reversed in, natural out (unscaled)
  for (int half = 1; half < N; half <<= 1) {
    const int tstride = half_n / half;
    for (int j = tid; j < half_n; j += nt) {
      const int pos = j & (half - 1);
      const int i0 = ((j & ~(half - 1)) << 1) | pos;
      const int i1 = i0 + half;
      float2 w = __ldg(tw + pos * tstride);
      w.y = -w.y;
      const float2 t = cmul(buf[i1], w);
      const float2 u = buf[i0];
      buf[i0] = make_float2(u.x + t.x, u.y + t.y);
      buf[i1] = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }

  // 5. store the output band
  const float inv_n = 1.0f / (float)N;
  const long long obase = (long long)b * out_sb + (long long)line * out_sl;
  for (int i = tid; i < out_len; i += nt) {
    const float2 v = buf[out_off + i];
    if (REAL_OUT) {
      static_cast<float*>(out_ptr)[obase + i * out_si] = v.x * inv_n;
    } else {
      static_cast<float2*>(out_ptr)[obase + i * out_si] =
          make_float2(v.x * inv_n, v.y * inv_n);
    }
  }
}

}  // namespace

// Shear `lines` lines of each of B frames. Strides are in elements (float
// for real data, float2 for complex). Returns cudaGetLastError().
extern "C" int vip_shear_lines(int real_in, int real_out, const void* in,
                               void* out, const double* coef, const void* tw,
                               int B, int lines, int N, int q0,
                               long long in_sb, long long in_sl,
                               long long in_si, int in_len, int in_off,
                               long long out_sb, long long out_sl,
                               long long out_si, int out_len, int out_off,
                               void* stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const int threads = N / 2 < 256 ? N / 2 : 256;
  const size_t smem = (size_t)N * sizeof(float2);
  const unsigned blocks = (unsigned)((long long)B * lines);
  cudaStream_t s = (cudaStream_t)stream;
  const float2* twc = static_cast<const float2*>(tw);
#define VIP_LAUNCH(RI, RO)                                                  \
  shear_lines_kernel<RI, RO><<<blocks, threads, smem, s>>>(                 \
      in, out, coef, twc, lines, N, logN, q0, in_sb, in_sl, in_si, in_len, \
      in_off, out_sb, out_sl, out_si, out_len, out_off)
  if (real_in && real_out) return (int)cudaErrorInvalidValue;
  if (real_in) {
    VIP_LAUNCH(true, false);
  } else if (real_out) {
    VIP_LAUNCH(false, true);
  } else {
    VIP_LAUNCH(false, false);
  }
#undef VIP_LAUNCH
  return (int)cudaGetLastError();
}
