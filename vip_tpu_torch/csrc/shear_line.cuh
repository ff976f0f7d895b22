// The radix-2 line shear shared by H2/H3 (csrc/fft_shear.cu, one launch per
// shear) and H4 (csrc/fft_shear3.cu, all three shears in one cooperative
// launch) on the canvases above 2048 points, where the register engine
// (shear_regs.cuh) does not run: one thread block shears one line of a
// canvas of N = p * M points, p odd <= 15, M = 2^m, 128 <= N <= 4096.
// fft_shear.cu's header comment gives the algorithm (steps 1-5 below) and
// the phase precision argument.
//
// Every thread of the block must call shear_line together (it synchronizes
// the block). The caller provides N float2 of dynamic shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vip {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// One pass of P-point DFTs over the M columns n2 (points n2, M + n2, ...,
// (P-1)*M + n2), in place: each thread holds its column's P inputs in
// registers and writes each output as it is formed. Forward: DFT, then
// twiddle W_N^(n2*k1). Inverse: conjugate twiddle, then the conjugate DFT.
template <int P, bool INV>
__device__ __forceinline__ void radix_p_pass(float2* buf,
                                             const float2* __restrict__ tw,
                                             int M, int tid, int nt) {
  for (int n2 = tid; n2 < M; n2 += nt) {
    float2 v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = buf[i * M + n2];
    if (INV) {
#pragma unroll
      for (int i = 1; i < P; ++i) v[i] = cmul(v[i], conjf2(__ldg(tw + n2 * i)));
    }
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) {
      float2 acc = v[0];
#pragma unroll
      for (int n1 = 1; n1 < P; ++n1) {
        float2 w = __ldg(tw + M * ((n1 * k1) % P));
        if (INV) w = conjf2(w);
        const float2 t = cmul(v[n1], w);
        acc.x += t.x;
        acc.y += t.y;
      }
      if (!INV && k1 > 0) acc = cmul(acc, __ldg(tw + n2 * k1));
      buf[k1 * M + n2] = acc;
    }
  }
}

// Load one input value. NC reads through the non-coherent read-only
// cache, for data no launch writes while it runs; otherwise the load
// bypasses L1 (ld.global.cg), for scratch that other blocks of the same
// launch wrote before a grid barrier.
template <typename T, bool NC>
__device__ __forceinline__ T load_in(const T* p) {
  if constexpr (NC) {
    return __ldg(p);
  } else {
    return __ldcg(p);
  }
}

// Shear one line: canvas coordinate q of the line, shear coefficient c.
// Input: in_len values at canvas offset in_off, element stride in_si from
// in_ptr + ibase (float if REAL_IN, else float2); zeros elsewhere. Output:
// out_len values from canvas offset out_off, element stride out_si from
// out_ptr + obase (the real part if REAL_OUT). The input and the output
// may be the same memory: every input value is read before any is written.
template <bool REAL_IN, bool REAL_OUT, int P, bool NC_IN>
__device__ __forceinline__ void shear_line(
    float2* buf, const void* in_ptr, long long ibase, long long in_si,
    int in_len, int in_off, void* out_ptr, long long obase,
    long long out_si, int out_len, int out_off, double c, int q,
    const float2* __restrict__ tw, int N, int logM) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int half_n = N >> 1;
  const int M = 1 << logM;
  const int half_m = M >> 1;

  // 1. load the occupied band, zeros elsewhere
  for (int i = tid; i < N; i += nt) {
    const int j = i - in_off;
    float2 v = make_float2(0.f, 0.f);
    if (j >= 0 && j < in_len) {
      if (REAL_IN) {
        v.x = load_in<float, NC_IN>(static_cast<const float*>(in_ptr) +
                                    ibase + j * in_si);
      } else {
        v = load_in<float2, NC_IN>(static_cast<const float2*>(in_ptr) +
                                   ibase + j * in_si);
      }
    }
    buf[i] = v;
  }
  __syncthreads();

  // 2. forward: p-point stage, then radix-2 DIF on each M-point sub-line
  if constexpr (P > 1) {
    radix_p_pass<P, false>(buf, tw, M, tid, nt);
    __syncthreads();
  }
  for (int half = half_m; half >= 1; half >>= 1) {
    const int tstride = P * (half_m / half);
    for (int j = tid; j < half_n; j += nt) {
      const int pos = j & (half - 1);
      const int i0 = ((j & ~(half - 1)) << 1) | pos;
      const int i1 = i0 + half;
      const float2 a = buf[i0];
      const float2 b = buf[i1];
      buf[i0] = make_float2(a.x + b.x, a.y + b.y);
      buf[i1] = cmul(make_float2(a.x - b.x, a.y - b.y), __ldg(tw + pos * tstride));
    }
    __syncthreads();
  }

  // 3. shear phase; slot M*k1 + r holds k = k1 + P*brev_m(r)
  const double cq = c * (double)(q - half_n);
  for (int slot = tid; slot < N; slot += nt) {
    const int k1 = slot >> logM;
    const int r = slot & (M - 1);
    int k = k1 + P * (int)(__brev((unsigned)r) >> (32 - logM));
    if (k >= half_n) k -= N;
    double cyc = cq * (double)k / (double)N;
    cyc -= rint(cyc);
    float s, co;
    sincospif(-2.0f * (float)cyc, &s, &co);
    buf[slot] = cmul(buf[slot], make_float2(co, s));
  }
  __syncthreads();

  // 4. inverse: radix-2 DIT on each sub-line, then the p-point stage
  for (int half = 1; half < M; half <<= 1) {
    const int tstride = P * (half_m / half);
    for (int j = tid; j < half_n; j += nt) {
      const int pos = j & (half - 1);
      const int i0 = ((j & ~(half - 1)) << 1) | pos;
      const int i1 = i0 + half;
      const float2 t = cmul(buf[i1], conjf2(__ldg(tw + pos * tstride)));
      const float2 u = buf[i0];
      buf[i0] = make_float2(u.x + t.x, u.y + t.y);
      buf[i1] = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }
  if constexpr (P > 1) {
    radix_p_pass<P, true>(buf, tw, M, tid, nt);
    __syncthreads();
  }

  // 5. store the output band
  const float inv_n = 1.0f / (float)N;
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

// The odd factor p of N and log2(N / p), or p = 0 for a canvas the line
// shear does not take.
inline void canvas_factors(int N, int* p, int* logM) {
  *p = 0;
  *logM = 0;
  if (N < 128 || N > 4096) return;
  int q = N, m = 0;
  while ((q & 1) == 0) {
    q >>= 1;
    ++m;
  }
  if (q > 15) return;
  *p = q;
  *logM = m;
}

}  // namespace vip

// Instantiate LAUNCH(P) for the odd factor p of the canvas; any other p
// returns cudaErrorInvalidValue from the enclosing function.
#define VIP_SWITCH_P(p, LAUNCH)                 \
  switch (p) {                                  \
    case 1: LAUNCH(1); break;                   \
    case 3: LAUNCH(3); break;                   \
    case 5: LAUNCH(5); break;                   \
    case 7: LAUNCH(7); break;                   \
    case 9: LAUNCH(9); break;                   \
    case 11: LAUNCH(11); break;                 \
    case 13: LAUNCH(13); break;                 \
    case 15: LAUNCH(15); break;                 \
    default: return (int)cudaErrorInvalidValue; \
  }
