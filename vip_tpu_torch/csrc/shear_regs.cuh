// The register-resident line shear of H2 and H3 (csrc/fft_shear.cu): a
// line of N = p * M points, p odd <= 15, M = 2^m, 128 <= N <= 2048, is
// held by T = N / 16 threads, 16 points each, in registers. fft_shear.cu's
// header comment gives the design; vip_tpu_torch/ops/shear.py builds the
// same plan on the host (`_line_plan`, `_freq_table`) and its CPU tests
// emulate it.
//
// The forward FFT is a mixed-radix decimation in frequency over the passes
// R_0, R_1, ..., R_{s-1} (prod R_i = N): a p-point pass first when p > 1,
// then radix-16 passes, then one pass of the remaining 2, 4 or 8. Pass i
// works on contiguous sub-blocks of S_i = N / (R_0 ... R_{i-1}) points with
// span L_i = S_i / R_i: its butterfly (blk, n'), n' < L_i, reads the R_i
// points blk*S_i + j*L_i + n' (j < R_i), forms their R_i-point DFT, times
// the twiddle W_{S_i}^(n'*k) = W_N^(n'*k*N/S_i) on output k, and writes
// output k back to point blk*S_i + k*L_i + n'. Butterfly beta = t + T*u
// (u < ceil(N/R_i/T)) belongs to thread t. The twiddles come from the pass
// table `ptw`, host-built in float64: pass i's block of S_i entries holds
// W_{S_i}^(n'*k) at k*L_i + n', blocks in pass order, so that the threads
// of a warp read consecutive entries. The result sits in digit-reversed
// order: point sum_i d_i*L_i holds frequency sum_i d_i*(R_0 ... R_{i-1}),
// the host-built int32 table `freq` (signed, -N/2..N/2-1) maps one to the
// other. The inverse runs the passes backwards, each the exact mirror
// (conjugate twiddle, then conjugate DFT), back to natural order. Between
// two passes the points go through shared memory once (write all, barrier,
// read all): s - 1 exchanges each way, 2 at N = 2048 (16, 16, 8).

#pragma once

#include "shear_line.cuh"

namespace vip {

// points a thread holds in a power-of-two pass; the largest canvas
constexpr int kRegPoints = 16;
constexpr int kRegMaxN = 2048;
constexpr int kRegMaxThreads = 512;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// float2 a thread's register array holds: 16, or the p-point pass's
// ceil(16/p) butterflies of p points
template <int P>
__host__ __device__ constexpr int reg_values() {
  return P * ceil_div(kRegPoints, P) > kRegPoints ? P * ceil_div(kRegPoints, P)
                                                 : kRegPoints;
}

// A line's shared-memory stride in float2 and the padded index of a point:
// one pad every 16 points keeps the strided exchanges off a single bank,
// and a stride of 4 mod 16 puts the four lines of a column group on
// different banks.
__host__ __device__ constexpr int reg_line_stride(int N) {
  return N + (N >> 4) + 4;
}
__device__ __forceinline__ int spad(int pos) { return pos + (pos >> 4); }

__host__ __device__ constexpr float cos16(int t) {
  switch (t & 15) {
    case 0: return 1.0f;
    case 1: case 15: return 0.92387953251128674f;
    case 2: case 14: return 0.70710678118654752f;
    case 3: case 13: return 0.38268343236508977f;
    case 4: case 12: return 0.0f;
    case 5: case 11: return -0.38268343236508977f;
    case 6: case 10: return -0.70710678118654752f;
    case 7: case 9: return -0.92387953251128674f;
    default: return -1.0f;
  }
}
__host__ __device__ constexpr float sin16(int t) { return cos16(t - 4); }

// a * W_16^t, W_16 = exp(-2*pi*i/16), conjugate twiddle if INV; t is a
// compile-time constant once the caller's loops are unrolled
template <bool INV>
__device__ __forceinline__ float2 mul_w16(float2 a, int t) {
  t &= 15;
  if (t == 0) return a;
  if (t == 8) return make_float2(-a.x, -a.y);
  if (t == 4) return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  if (t == 12) return INV ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
  return cmul(a, make_float2(cos16(t), INV ? sin16(t) : -sin16(t)));
}

template <int R>
__host__ __device__ constexpr int brev_r(int k) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1) r = (r << 1) | ((k & b) ? 1 : 0);
  return r;
}

// R-point DFT (R = 2, 4, 8, 16) in registers, natural order in and out:
// radix-2 decimation in frequency, then a renaming of the registers.
template <int R, bool INV>
__device__ __forceinline__ void dft_pow2(float2* a) {
#pragma unroll
  for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const int pos = j & (half - 1);
      const int i0 = ((j & ~(half - 1)) << 1) | pos;
      const int i1 = i0 + half;
      const float2 x = a[i0];
      const float2 y = a[i1];
      a[i0] = make_float2(x.x + y.x, x.y + y.y);
      a[i1] = mul_w16<INV>(make_float2(x.x - y.x, x.y - y.y),
                           pos * (16 / (2 * half)));
    }
  }
  float2 tmp[R];
#pragma unroll
  for (int k = 0; k < R; ++k) tmp[k] = a[brev_r<R>(k)];
#pragma unroll
  for (int k = 0; k < R; ++k) a[k] = tmp[k];
}

// P-point DFT, direct: X[k] = sum_n x[n] W_P^(n*k), W_P^j = tw[M*j] (the
// host's float64 table, read as float32), conjugate if INV.
template <int P, bool INV>
__device__ __forceinline__ void dft_p(float2* a, const float2* __restrict__ tw,
                                      int M) {
  float2 out[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float2 acc = a[0];
#pragma unroll
    for (int n = 1; n < P; ++n) {
      float2 w = __ldg(tw + M * ((n * k) % P));
      if (INV) w = conjf2(w);
      const float2 t = cmul(a[n], w);
      acc.x += t.x;
      acc.y += t.y;
    }
    out[k] = acc;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) a[k] = out[k];
}

// The p-point pass (pass 0 when p > 1: S = N, L = M): butterfly beta < M
// reads points j*M + beta. Forward: DFT, then twiddle W_N^(beta*k) =
// ptw[k*M + beta]. Inverse: conjugate twiddle, then conjugate DFT.
template <int P, bool INV>
__device__ __forceinline__ void pass_p(float2* v, const float2* __restrict__ tw,
                                       const float2* __restrict__ ptw, int M,
                                       int t, int T) {
  constexpr int U = ceil_div(kRegPoints, P);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int beta = t + T * u;
    if (beta >= M) continue;
    float2* a = v + u * P;
    if (INV) {
#pragma unroll
      for (int k = 1; k < P; ++k)
        a[k] = cmul(a[k], conjf2(__ldg(ptw + k * M + beta)));
    }
    dft_p<P, INV>(a, tw, M);
    if (!INV) {
#pragma unroll
      for (int k = 1; k < P; ++k)
        a[k] = cmul(a[k], __ldg(ptw + k * M + beta));
    }
  }
}

// A power-of-two pass of radix R on sub-blocks of S points, span L = S / R
// = 2^logL; each thread owns 16 / R butterflies. The twiddle of output k of
// butterfly n' is W_S^(n'*k) = ptw[k*L + n'] (the pass's block of the pass
// table: a warp reads consecutive entries); the last pass (L = 1) has none.
template <int R, bool INV>
__device__ __forceinline__ void pass_pow2(float2* v,
                                          const float2* __restrict__ ptw,
                                          int logL, int t, int T) {
  constexpr int U = kRegPoints / R;
  const int L = 1 << logL;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int np = (t + T * u) & (L - 1);
    float2* a = v + u * R;
    if (INV && L > 1) {
#pragma unroll
      for (int k = 1; k < R; ++k)
        a[k] = cmul(a[k], conjf2(__ldg(ptw + k * L + np)));
    }
    dft_pow2<R, INV>(a);
    if (!INV && L > 1) {
#pragma unroll
      for (int k = 1; k < R; ++k) a[k] = cmul(a[k], __ldg(ptw + k * L + np));
    }
  }
}

// Move a power-of-two pass's points between registers and the line's
// shared memory (WRITE: registers -> shared memory).
template <int R, bool WRITE>
__device__ __forceinline__ void xfer_pow2(float2* line, float2* v, int logL,
                                          int logS, int t, int T) {
  constexpr int U = kRegPoints / R;
  const int L = 1 << logL;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int beta = t + T * u;
    const int base = ((beta >> logL) << logS) + (beta & (L - 1));
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int at = spad(base + j * L);
      if (WRITE) {
        line[at] = v[u * R + j];
      } else {
        v[u * R + j] = line[at];
      }
    }
  }
}

// The same for the p-point pass: butterfly beta < M owns points j*M + beta.
template <int P, bool WRITE>
__device__ __forceinline__ void xfer_p(float2* line, float2* v, int M, int t,
                                       int T) {
  constexpr int U = ceil_div(kRegPoints, P);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int beta = t + T * u;
    if (beta >= M) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int at = spad(j * M + beta);
      if (WRITE) {
        line[at] = v[u * P + j];
      } else {
        v[u * P + j] = line[at];
      }
    }
  }
}

// Runtime radix R in {2, 4, 8, 16} -> the templates above.
template <bool INV>
__device__ __forceinline__ void pass_r(int R, float2* v,
                                       const float2* __restrict__ ptw,
                                       int logL, int t, int T) {
  switch (R) {
    case 16: pass_pow2<16, INV>(v, ptw, logL, t, T); break;
    case 8: pass_pow2<8, INV>(v, ptw, logL, t, T); break;
    case 4: pass_pow2<4, INV>(v, ptw, logL, t, T); break;
    default: pass_pow2<2, INV>(v, ptw, logL, t, T); break;
  }
}

template <bool WRITE>
__device__ __forceinline__ void xfer_r(int R, float2* line, float2* v,
                                       int logL, int logS, int t, int T) {
  switch (R) {
    case 16: xfer_pow2<16, WRITE>(line, v, logL, logS, t, T); break;
    case 8: xfer_pow2<8, WRITE>(line, v, logL, logS, t, T); break;
    case 4: xfer_pow2<4, WRITE>(line, v, logL, logS, t, T); break;
    default: xfer_pow2<2, WRITE>(line, v, logL, logS, t, T); break;
  }
}

// Power-of-two pass i of a line with log2(M) = logM: radix 16 for the first
// logM / 4 passes, then 2^(logM % 4).
__device__ __forceinline__ int pow2_log_radix(int i, int logM) {
  return i < (logM >> 2) ? 4 : (logM & 3);
}

// Shear one line held by threads t < T of its group (T = N / 16): canvas
// coordinate q, shear coefficient c. Input: in_len values at canvas offset
// in_off, element stride in_si from in_ptr + ibase (float if REAL_IN, else
// float2); zeros elsewhere. Output: out_len values from canvas offset
// out_off, element stride out_si from out_ptr + obase (the real part if
// REAL_OUT). `line` is the line's shared memory (reg_line_stride(N) float2).
// An inactive line (past the end of the batch) loads and stores nothing but
// still reaches every barrier: all threads of the block call this together.
// NC is the input's load policy (load_in, shear_line.cuh): the read-only
// path for data no block of the launch writes, else ld.global.cg. The
// input and the output may be the same memory: every point is loaded in
// step 1, before the first barrier, and stored in step 5.
template <bool REAL_IN, bool REAL_OUT, int P, bool NC = true>
__device__ __forceinline__ void shear_line_regs(
    float2* line, const void* in_ptr, long long ibase, long long in_si,
    int in_len, int in_off, void* out_ptr, long long obase, long long out_si,
    int out_len, int out_off, double c, int q, const float2* __restrict__ tw,
    const float2* __restrict__ ptw, const int* __restrict__ freq, int N,
    int logM, int t, int T, bool active) {
  constexpr int R0 = P > 1 ? P : 16;
  constexpr int U0 = ceil_div(kRegPoints, R0);
  const int M = 1 << logM;
  const int L0 = N / R0;            // span of pass 0 (M when p > 1)
  const int B0 = L0;                // its butterflies
  const int npow = (logM >> 2) + ((logM & 3) ? 1 : 0);
  float2 v[reg_values<P>()];

  // 1. load pass 0's points straight from device memory: the occupied
  //    band, zeros elsewhere
#pragma unroll
  for (int u = 0; u < U0; ++u) {
    const int beta = t + T * u;
#pragma unroll
    for (int j = 0; j < R0; ++j) {
      float2 x = make_float2(0.f, 0.f);
      const int k = j * L0 + beta - in_off;
      if (active && beta < B0 && k >= 0 && k < in_len) {
        if (REAL_IN) {
          x.x = load_in<float, NC>(static_cast<const float*>(in_ptr) + ibase +
                                   k * in_si);
        } else {
          x = load_in<float2, NC>(static_cast<const float2*>(in_ptr) + ibase +
                                  k * in_si);
        }
      }
      v[u * R0 + j] = x;
    }
  }

  // 2. forward passes. Pow2 pass i works on sub-blocks of S = 2^logS
  //    points (logS = logM before the first), span L = S / R, its twiddle
  //    table block at ptw + off; an exchange precedes every pass but the
  //    first.
  if constexpr (P > 1) pass_p<P, false>(v, tw, ptw, M, t, T);
  int logS = logM;
  int off = P > 1 ? N : 0;
  for (int i = 0; i < npow; ++i) {
    const int logR = pow2_log_radix(i, logM);
    if (P > 1 || i > 0) {
      __syncthreads();
      if (P > 1 && i == 0) {
        xfer_p<P, true>(line, v, M, t, T);
      } else {
        const int pr = pow2_log_radix(i - 1, logM);
        xfer_r<true>(1 << pr, line, v, logS, logS + pr, t, T);
      }
      __syncthreads();
      xfer_r<false>(1 << logR, line, v, logS - logR, logS, t, T);
    }
    pass_r<false>(1 << logR, v, ptw + off, logS - logR, t, T);
    off += 1 << logS;
    logS -= logR;
  }

  // 3. shear phase on the last pass's points, in registers: its butterfly
  //    beta owns points beta*R + j, which hold frequency freq[beta*R + j]
  {
    const int logR = pow2_log_radix(npow - 1, logM);
    const int R = 1 << logR;
    const double cq = c * (double)(q - (N >> 1));
#pragma unroll
    for (int e = 0; e < kRegPoints; ++e) {
      const int u = e >> logR;
      const int pos = ((t + T * u) << logR) + (e & (R - 1));
      const int k = __ldg(freq + pos);
      double cyc = cq * (double)k / (double)N;
      cyc -= rint(cyc);
      float s, co;
      sincospif(-2.0f * (float)cyc, &s, &co);
      v[e] = cmul(v[e], make_float2(co, s));
    }
  }

  // 4. inverse passes, the forward ones backwards
  for (int i = npow - 1; i >= 0; --i) {
    const int logR = pow2_log_radix(i, logM);
    logS += logR;
    off -= 1 << logS;
    pass_r<true>(1 << logR, v, ptw + off, logS - logR, t, T);
    if (P > 1 || i > 0) {
      __syncthreads();
      xfer_r<true>(1 << logR, line, v, logS - logR, logS, t, T);
      __syncthreads();
      if (P > 1 && i == 0) {
        xfer_p<P, false>(line, v, M, t, T);
      } else {
        const int pr = pow2_log_radix(i - 1, logM);
        xfer_r<false>(1 << pr, line, v, logS, logS + pr, t, T);
      }
    }
  }
  if constexpr (P > 1) pass_p<P, true>(v, tw, ptw, M, t, T);

  // 5. store pass 0's points of the output band, scaled by 1/N
  const float inv_n = 1.0f / (float)N;
#pragma unroll
  for (int u = 0; u < U0; ++u) {
    const int beta = t + T * u;
#pragma unroll
    for (int j = 0; j < R0; ++j) {
      const int k = j * L0 + beta - out_off;
      if (active && beta < B0 && k >= 0 && k < out_len) {
        const float2 x = v[u * R0 + j];
        if (REAL_OUT) {
          static_cast<float*>(out_ptr)[obase + k * out_si] = x.x * inv_n;
        } else {
          static_cast<float2*>(out_ptr)[obase + k * out_si] =
              make_float2(x.x * inv_n, x.y * inv_n);
        }
      }
    }
  }
}

// A line of real input, read straight from a frame: where its first point
// lies, the stride between its points, how many there are (0 for none)
// and the canvas offset of the first.
struct RowIn {
  long long base, step;
  int len, off;
};

// Row r of the band that the first x-shear reads: the y x y frame at
// `fbase` (row stride rs, point stride ps), turned by rot90 of quadrant k
// (numpy's direction) and placed one row down for k = 1, 2 and one point
// right for k = 2, 3, as the reference rot90s the (N+1)-extended canvas;
// the frame's column 0 otherwise sits at canvas offset `off`. Row i = r -
// dy of the turned frame, element j, is frame element (i, j) (k = 0),
// (j, y-1-i) (1), (y-1-i, y-1-j) (2) or (y-1-j, i) (3).
__device__ __forceinline__ RowIn rot90_row(int k, int r, int y,
                                           long long fbase, long long rs,
                                           long long ps, int off) {
  const int dy = (k == 1 || k == 2) ? 1 : 0;
  const int dx = k >= 2 ? 1 : 0;
  const long long i = r - dy;
  const long long e = y - 1;
  if (i < 0 || i > e) return {fbase, ps, 0, off + dx};
  switch (k) {
    case 0: return {fbase + i * rs, ps, y, off};
    case 1: return {fbase + (e - i) * ps, rs, y, off};
    case 2: return {fbase + (e - i) * rs + e * ps, -ps, y, off + dx};
    default: return {fbase + e * rs + i * ps, -rs, y, off + dx};
  }
}

// One launch of the register engine: what vip_shear_lines (fft_shear.cu)
// checked and passes on. Strides in elements; `cols` picks the column
// kernel, `group` the lines a block; `quad` the frames' quadrants when the
// input is real (rot90_row).
struct RegArgs {
  bool real_in, real_out, cols;
  const void* in;
  void* out;
  const double* coef;
  const float2* tw;
  const float2* ptw;
  const int* freq;
  const long long* quad;
  int B, lines, group, N, logM, q0;
  long long in_sb, in_sl, in_si;
  int in_len, in_off;
  long long out_sb, out_sl, out_si;
  int out_len, out_off;
};

namespace {

// The register engine on rows (the x-shears): `group` rows a block, T =
// N / 16 threads a row; thread l*T + t holds row l from point t. Real
// input is the frames themselves, read through rot90_row.
template <bool REAL_IN, bool REAL_OUT, int P>
__global__ void __launch_bounds__(kRegMaxThreads)
    shear_rows_kernel(const RegArgs a) {
  extern __shared__ float2 smem[];
  const int T = a.N >> 4;
  const int per_frame = (a.lines + a.group - 1) / a.group;
  const int b = blockIdx.x / per_frame;
  const int l = threadIdx.x / T;
  const int t = threadIdx.x - l * T;
  const int line = (blockIdx.x - b * per_frame) * a.group + l;
  RowIn in{(long long)b * a.in_sb + (long long)line * a.in_sl, a.in_si,
           a.in_len, a.in_off};
  if (REAL_IN)
    in = rot90_row((int)(a.quad[b] & 3), line, a.in_len,
                   (long long)b * a.in_sb, a.in_sl, a.in_si, a.in_off);
  shear_line_regs<REAL_IN, REAL_OUT, P>(
      smem + l * reg_line_stride(a.N), a.in, in.base, in.step, in.len,
      in.off, a.out, (long long)b * a.out_sb + (long long)line * a.out_sl,
      a.out_si, a.out_len, a.out_off, a.coef[b], a.q0 + line, a.tw, a.ptw,
      a.freq, a.N, a.logM, t, T, line < a.lines);
}

// The register engine on columns (the y-shear, complex in and out):
// `group` (a multiple of 4) adjacent columns a block; thread c + group*t
// holds column c from row t, so a warp's loads and stores cover whole
// 32-byte sectors of 4 adjacent complex64.
template <int P>
__global__ void __launch_bounds__(kRegMaxThreads)
    shear_cols_kernel(const RegArgs a) {
  extern __shared__ float2 smem[];
  const int T = a.N >> 4;
  const int per_frame = (a.lines + a.group - 1) / a.group;
  const int b = blockIdx.x / per_frame;
  const int c = threadIdx.x % a.group;
  const int t = threadIdx.x / a.group;
  const int line = (blockIdx.x - b * per_frame) * a.group + c;
  shear_line_regs<false, false, P>(
      smem + c * reg_line_stride(a.N), a.in,
      (long long)b * a.in_sb + (long long)line * a.in_sl, a.in_si, a.in_len,
      a.in_off, a.out, (long long)b * a.out_sb + (long long)line * a.out_sl,
      a.out_si, a.out_len, a.out_off, a.coef[b], a.q0 + line, a.tw, a.ptw,
      a.freq, a.N, a.logM, t, T, line < a.lines);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory: above 48 KB
// that needs cudaFuncAttributeMaxDynamicSharedMemorySize, set once per
// kernel instantiation and device (`granted`, the instantiation's own).
template <typename Kernel>
int launch_one(Kernel kernel, const RegArgs& a, cudaStream_t stream,
               size_t* granted) {
  const int threads = a.group * (a.N >> 4);
  const size_t smem = (size_t)a.group * reg_line_stride(a.N) * sizeof(float2);
  const unsigned blocks =
      (unsigned)((long long)a.B * ((a.lines + a.group - 1) / a.group));
  if (smem > (size_t)(48 << 10)) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
    if (granted[dev] < smem) {
      err = cudaFuncSetAttribute((const void*)kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      granted[dev] = smem;
    }
  }
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the register engine for the odd factor P of the canvas.
// Each P is instantiated in one of the csrc/shear_regs_p*.cu sources, so
// that nvcc builds them in parallel.
template <int P>
int launch_regs(const RegArgs& a, cudaStream_t stream) {
  static size_t granted[4][16];
  if (a.cols) return launch_one(shear_cols_kernel<P>, a, stream, granted[0]);
  if (a.real_in)
    return launch_one(shear_rows_kernel<true, false, P>, a, stream,
                      granted[1]);
  if (a.real_out)
    return launch_one(shear_rows_kernel<false, true, P>, a, stream,
                      granted[2]);
  return launch_one(shear_rows_kernel<false, false, P>, a, stream,
                    granted[3]);
}

extern template int launch_regs<1>(const RegArgs&, cudaStream_t);
extern template int launch_regs<3>(const RegArgs&, cudaStream_t);
extern template int launch_regs<5>(const RegArgs&, cudaStream_t);
extern template int launch_regs<7>(const RegArgs&, cudaStream_t);
extern template int launch_regs<9>(const RegArgs&, cudaStream_t);
extern template int launch_regs<11>(const RegArgs&, cudaStream_t);
extern template int launch_regs<13>(const RegArgs&, cudaStream_t);
extern template int launch_regs<15>(const RegArgs&, cudaStream_t);

}  // namespace vip
