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
// Each line (a row for the x-shears, a column for the y-shear) of a canvas
// of N = p * M points, p odd <= 15, M = 2^m, 128 <= N <= 4096 (every
// canvas vip_tpu's K2 and K3 gates accept: N = 128 * P, P <= 16) is
// sheared in five steps, written here for the radix-2 body:
//   1. load the line's occupied band (in_len values at canvas offset
//      in_off, real or complex) as complex64, zeros elsewhere: the padded
//      canvas never exists in device memory. The first x-shear reads the
//      frames themselves, each as its quadrant's rot90 (rot90_row,
//      shear_regs.cuh), so the rot90-placed frames never exist either;
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
// Two line engines, chosen by N alone (`vip_tpu_torch.ops.shear.
// register_engine_takes`): N <= 2048 runs the register-resident engine of
// shear_regs.cuh; larger canvases (2304 .. 4096, frames of 576 to 1024
// px) run the radix-2 body `vip::shear_line` of shear_line.cuh. H4
// (fft_shear3.cu) runs the same engine as H2 and H3 on each canvas, in one
// cooperative launch. Steps 1-5 above hold for both; the register
// engine orders the forward passes as its digit-reversed plan and reads
// each slot's frequency from a host-built int32 table.
//
// What bounds it on this card. At N = 2048 a line is 5 N log2 N = 113 kflop
// each way, about 36.5 Gflop per 50-frame chunk of 512^2 frames (153,650
// lines: 25,650 + 102,400 + ~25,600), 0.55 ms at the float32 peak; its
// device-memory traffic (frames in, two complex bands written and read,
// frames out) is ~1.4 GB, ~0.4 ms. The radix-2 body spent its time instead in 22
// shared-memory stages a line, each a full read and write of the line and
// a barrier, with one block a line. The register engine:
//   - keeps each thread's 16 points in registers (T = N / 16 threads a
//     line) and runs radix-16 passes there (16, 16, 8 at N = 2048; 5, 16, 8
//     at N = 640), with the inter-pass twiddles from the table; shared
//     memory only between passes: 2 exchanges each way at N = 2048 (one
//     write, one barrier, one read, padded against bank conflicts);
//   - shears several lines a block: the x-shears (rows) ceil(256 / T) rows,
//     whose loads and stores are coalesced along the row; the y-shear
//     (columns) C >= 4 adjacent columns, thread c + C*t owning column c and
//     base row t, so that a warp's load or store covers 32 / C rows of C
//     contiguous complex64 (whole 32-byte sectors), with no transposition.

#include "shear_regs.cuh"

namespace {

// The radix-2 body, one block per line; the line's index in the batch is
// blockIdx.x.
template <bool REAL_IN, bool REAL_OUT, int P>
__global__ void shear_lines_radix2_kernel(
    const void* __restrict__ in_ptr, void* __restrict__ out_ptr,
    const double* __restrict__ coef, const float2* __restrict__ tw,
    const long long* __restrict__ quad, int lines, int N, int logM, int q0,
    long long in_sb, long long in_sl, long long in_si, int in_len, int in_off,
    long long out_sb, long long out_sl, long long out_si, int out_len,
    int out_off) {
  extern __shared__ float2 buf[];
  const int line = blockIdx.x % lines;
  const int b = blockIdx.x / lines;
  vip::RowIn in{(long long)b * in_sb + (long long)line * in_sl, in_si, in_len,
                in_off};
  if (REAL_IN)
    in = vip::rot90_row((int)(quad[b] & 3), line, in_len,
                        (long long)b * in_sb, in_sl, in_si, in_off);
  vip::shear_line<REAL_IN, REAL_OUT, P, true>(
      buf, in_ptr, in.base, in.step, in.len, in.off, out_ptr,
      (long long)b * out_sb + (long long)line * out_sl, out_si, out_len,
      out_off, coef[b], q0 + line, tw, N, logM);
}

}  // namespace

// Shear `lines` lines of each of B frames on a canvas of N = p * 2^m
// points (p odd <= 15, 128 <= N <= 4096). `tw` holds exp(-2*pi*i*t/N) for
// t < N as complex64. Strides are in elements (float for real data,
// float2 for complex).
//
// Real input is B square frames of in_len x in_len (frame stride in_sb,
// row stride in_sl, point stride in_si), read in place as the rot90 of
// quadrant quad[b] (int64 per frame) placed as the reference places it
// (shear_regs.cuh, rot90_row): line r of the launch reads row r - dy of
// the turned frame, whose column 0 sits at canvas offset in_off + dx.
// There are no placed frames in device memory.
//
// N <= 2048 runs the register engine: rows (in_si = out_si = 1, `group`
// rows a block) or columns (in_sl = out_sl = 1, complex in and out,
// `group` columns a block, a multiple of 4); group * N / 16 threads a
// block, at most 512. `ptw` is its pass twiddle table and `freq` its slot
// -> signed frequency table (int32, N entries), both of its plan
// (shear_regs.cuh). Larger N runs the radix-2 body, one block a line, and
// ignores `ptw`, `freq` and `group`.
//
// Returns cudaGetLastError(), the error of the shared-memory attribute
// call, or cudaErrorInvalidValue for a canvas or a combination it does not
// take.
extern "C" int vip_shear_lines(int real_in, int real_out, const void* in,
                               void* out, const double* coef, const void* tw,
                               const void* ptw, const void* freq,
                               const void* quad, int B, int lines, int group,
                               int N, int q0, long long in_sb,
                               long long in_sl, long long in_si, int in_len,
                               int in_off, long long out_sb, long long out_sl,
                               long long out_si, int out_len, int out_off,
                               void* stream) {
  int p, logM;
  vip::canvas_factors(N, &p, &logM);
  if (p == 0 || (real_in && real_out) || (real_in && quad == nullptr) ||
      B < 1 || lines < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* twc = static_cast<const float2*>(tw);
  const long long* quadc = static_cast<const long long*>(quad);

  if (N > vip::kRegMaxN) {
    const int threads = 256;
    const size_t smem = (size_t)N * sizeof(float2);
    const unsigned blocks = (unsigned)((long long)B * lines);
#define VIP_LAUNCH(RI, RO, PP)                                               \
  shear_lines_radix2_kernel<RI, RO, PP><<<blocks, threads, smem, s>>>(       \
      in, out, coef, twc, quadc, lines, N, logM, q0, in_sb, in_sl, in_si,    \
      in_len, in_off, out_sb, out_sl, out_si, out_len, out_off)
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

  const bool rows = in_si == 1 && out_si == 1;
  const bool cols = !rows && in_sl == 1 && out_sl == 1 && !real_in &&
                    !real_out && group % 4 == 0;
  if (!(rows || cols) || ptw == nullptr || freq == nullptr || group < 1 ||
      group * (N >> 4) > vip::kRegMaxThreads)
    return (int)cudaErrorInvalidValue;
  const vip::RegArgs a{real_in != 0, real_out != 0, cols, in, out, coef, twc,
                       static_cast<const float2*>(ptw),
                       static_cast<const int*>(freq), quadc, B, lines,
                       group, N,
                       logM, q0, in_sb, in_sl, in_si, in_len, in_off, out_sb,
                       out_sl, out_si, out_len, out_off};
#define VIP_REGS(PP) return vip::launch_regs<PP>(a, s)
  VIP_SWITCH_P(p, VIP_REGS)
#undef VIP_REGS
  return (int)cudaErrorInvalidValue;
}
