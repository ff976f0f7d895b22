// H2 and H3: one FFT shear of a three-shear rotation, for Hopper (sm_90a).
// Three launches (x-shear, y-shear, x-shear) rotate a batch of frames;
// vip_tpu_torch/ops/shear.py drives them.
//
// Replaces two of vip_tpu's Pallas TPU kernels, which share the shear
// bodies `_shear_x` (vip_tpu/ops/pallas_shear.py:442-494, via
// `_shear_rows_body` :214-271) and `_shear_y` (:497-544, via
// `_shear_cols_body` :298-353):
//   - H2, `rotate_fft_exact_fused` (:550-613): VIP's exact 4x-padded
//     rotation, with support-pruned bands;
//   - H3, `rotate_fft_small_fused` (:918-954): the same three shears on a
//     full N x N canvas (fft-small mode), no pruning, real part out.
// It computes what those compute, not how: the TPU kernels' 128-lane fold,
// bf16 hi/lo splits and matmul DFT are not carried over.
//
// One thread block shears one line (a row for the x-shears, a column for
// the y-shear) of a canvas of N = p * M points, p odd <= 15, M = 2^m,
// 128 <= N <= 4096 (every canvas vip_tpu's K2 and K3 gates accept:
// N = 128 * P, P <= 16):
//   1. load the line's occupied band (in_len values at canvas offset
//      in_off, real or complex) into shared memory as complex64, zeros
//      elsewhere: the padded canvas never exists in device memory;
//   2. forward FFT, mixed radix: with n = M*n1 + n2 and k = k1 + p*k2,
//        X[k1 + p*k2] = sum_n2 W_M^(n2*k2) W_N^(n2*k1)
//                       sum_n1 x[M*n1 + n2] W_p^(n1*k1),
//      so one stage of p-point direct DFTs over the p points n2, M+n2, ...
//      (in place: output k1 goes to position M*k1 + n2), times the
//      twiddle W_N^(n2*k1), then a radix-2 decimation-in-frequency FFT on
//      each of the p contiguous sub-lines of M points (natural order in,
//      bit-reversed out). Position M*k1 + r then holds frequency
//      k = k1 + p*brev_m(r). For p = 1 the first stage is skipped;
//   3. multiply the slot of frequency k by exp(-2*pi*i * c * (q - N/2) *
//      k / N), k signed (k >= N/2 -> k - N, so -N/2 is the Nyquist slot as
//      in numpy's fftfreq), q the canvas coordinate of the line and c the
//      frame's shear coefficient (float64, as the plain version takes it).
//      c*(q-N/2)*k/N reaches ~360 cycles at N = 2048, where float32 loses
//      ~1e-4 rad: the cycle count is formed in float64 (exact integer
//      (q-N/2)*k times c), reduced to [-1/2, 1/2] in float64, and only then
//      evaluated with sincospif in float32;
//   4. inverse FFT, the mirror of step 2: radix-2 decimation-in-time on
//      each sub-line (bit-reversed in, natural out) with conjugate
//      twiddles, then the conjugate twiddle W_N^-(n2*k1) and p-point
//      inverse DFTs back to natural order; scaled by 1/N at the store;
//   5. store only the output band (out_len points at canvas offset
//      out_off), complex or its real part.
// Twiddles exp(-2*pi*i*t/N), t < N, are built on the host in float64 and
// read as float32 through the read-only cache: the p-point DFTs use
// W_p^j = W_N^(M*j), the radix-2 stages W_M^t = W_N^(p*t).
//
// What bounds it on this card: shared-memory traffic and barriers. Each
// radix-2 stage reads and writes the whole line in shared memory and ends
// in __syncthreads (2*log2(N) = 22 stages at N = 2048); a p-point stage
// costs p complex multiply-adds per point, one pass each way. The
// device-memory traffic is the bands between shears (H2: ~60 MB per 512^2
// frame; H3: three full 640^2 canvases, ~8 MB per frame). The y-shear
// reads and writes columns with a row stride, so its loads use a quarter
// of each 32-byte sector. Next steps, for later: radix-4/8 stages in
// registers and several columns per block for coalesced y-shear loads.
// The line shear itself (steps 1-5) is `vip::shear_line` in
// shear_line.cuh, which H4 (fft_shear3.cu, the three shears in one
// launch) shares.

#include "shear_line.cuh"

namespace {

// One block per line; the line's index in the batch is blockIdx.x.
template <bool REAL_IN, bool REAL_OUT, int P>
__global__ void shear_lines_kernel(
    const void* __restrict__ in_ptr, void* __restrict__ out_ptr,
    const double* __restrict__ coef, const float2* __restrict__ tw,
    int lines, int N, int logM, int q0,
    long long in_sb, long long in_sl, long long in_si, int in_len, int in_off,
    long long out_sb, long long out_sl, long long out_si, int out_len,
    int out_off) {
  extern __shared__ float2 buf[];
  const int line = blockIdx.x % lines;
  const int b = blockIdx.x / lines;
  vip::shear_line<REAL_IN, REAL_OUT, P, true>(
      buf, in_ptr, (long long)b * in_sb + (long long)line * in_sl, in_si,
      in_len, in_off, out_ptr, (long long)b * out_sb + (long long)line * out_sl,
      out_si, out_len, out_off, coef[b], q0 + line, tw, N, logM);
}

}  // namespace

// Shear `lines` lines of each of B frames on a canvas of N = p * 2^m
// points (p odd <= 15, 128 <= N <= 4096). `tw` holds exp(-2*pi*i*t/N) for
// t < N as complex64. Strides are in elements (float for real data,
// float2 for complex). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a canvas or a combination it does not take.
extern "C" int vip_shear_lines(int real_in, int real_out, const void* in,
                               void* out, const double* coef, const void* tw,
                               int B, int lines, int N, int q0,
                               long long in_sb, long long in_sl,
                               long long in_si, int in_len, int in_off,
                               long long out_sb, long long out_sl,
                               long long out_si, int out_len, int out_off,
                               void* stream) {
  int p, logM;
  vip::canvas_factors(N, &p, &logM);
  if (p == 0 || (real_in && real_out)) return (int)cudaErrorInvalidValue;
  const int threads = N / 2 < 256 ? N / 2 : 256;
  const size_t smem = (size_t)N * sizeof(float2);
  const unsigned blocks = (unsigned)((long long)B * lines);
  cudaStream_t s = (cudaStream_t)stream;
  const float2* twc = static_cast<const float2*>(tw);
#define VIP_LAUNCH(RI, RO, PP)                                               \
  shear_lines_kernel<RI, RO, PP><<<blocks, threads, smem, s>>>(              \
      in, out, coef, twc, lines, N, logM, q0, in_sb, in_sl, in_si, in_len,   \
      in_off, out_sb, out_sl, out_si, out_len, out_off)
#define VIP_LAUNCH_P(PP)                                                     \
  if (real_in) {                                                             \
    VIP_LAUNCH(true, false, PP);                                             \
  } else if (real_out) {                                                     \
    VIP_LAUNCH(false, true, PP);                                             \
  } else {                                                                   \
    VIP_LAUNCH(false, false, PP);                                            \
  }
  VIP_SWITCH_P(p, VIP_LAUNCH_P)
#undef VIP_LAUNCH_P
#undef VIP_LAUNCH
  return (int)cudaGetLastError();
}
