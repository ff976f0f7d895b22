// H4: the three FFT shears of a rotation in ONE cooperative launch, for
// Hopper (sm_90a). vip_tpu_torch/ops/shear.py (rotate_fft_exact_fused3,
// rotate_fft_small_fused3) drives it.
//
// Replaces vip_tpu's Pallas TPU kernel `_fused3_call`
// (vip_tpu/ops/pallas_shear.py:694-842), reached by
// `rotate_fft_exact_fused3` (:845) and `rotate_fft_small_fused3` (:890):
// the function of H2 (exact, support-pruned bands) and of H3 (full
// N x N canvas, fft-small mode), with all three shears in one launch and
// the complex intermediate bands kept out of the HBM round trips between
// launches. The TPU kernel's 128-lane folds, bf16 hi/lo matmul DFT and
// fori-loop blocking are not carried over: each line is H2's mixed-radix
// line shear (`vip::shear_line`, shear_line.cuh), so H4 computes H2's and
// H3's arithmetic exactly (same float64 coefficients, twiddle table and
// phase reduction).
//
// Design. The intermediate band of one 512^2 frame is (y+1) x N complex64
// = 513 x 2048 x 8 B = 8.4 MB: more than a block's 227 KB of shared memory
// or a cluster's, less than the 50 MB L2. So the launch is persistent and
// cooperative: the grid is as large as can be co-resident (occupancy x
// SMs, cudaLaunchCooperativeKernel refuses anything larger), and it walks
// the batch in groups of G frames whose scratch (G x R1 x N complex64,
// allocated by the wrapper, ~40 MB) can stay L2-resident. Per group:
//   stage 1  blocks stride over the R1 occupied rows of the group's frames:
//            x-shear of the row band -> full rows of the scratch;
//   grid.sync()
//   stage 2  blocks stride over the N columns: y-shear of each column's R1
//            occupied rows -> its R2 crop rows, written IN PLACE into the
//            same column of the scratch (one block owns a whole column and
//            reads it all before it writes, so nothing else reads it);
//   grid.sync()
//   stage 3  blocks stride over the R2 crop rows: x-shear -> the real
//            output columns [cx0, cx0 + W3);
//   grid.sync()  (the next group reuses the scratch)
// Scratch is read with ld.global.cg: blocks of the same launch wrote it,
// and the non-coherent read-only path could serve a stale line of the
// previous group.
//
// What bounds it on this card: as H2, the shared-memory stages and
// barriers of the line FFTs (5 N log2 N flop a complex FFT, ~4% of the
// float32 peak for H2 at N = 2048); the scratch traffic that H2 sends to
// HBM (~60 MB a 512^2 frame) goes to L2 here when it stays resident (not
// guaranteed: no access-policy window is set).

#include <cooperative_groups.h>

#include "shear_line.cuh"

namespace cg = cooperative_groups;

namespace {

struct Geometry {
  int B;          // frames
  int G;          // frames per group (scratch holds G frames)
  int N, logM;    // canvas
  long long in_sb, in_sl;  // input slab strides (frame, row), floats
  int R1, W1;     // occupied rows of the slab and its width
  int py0, px0;   // canvas row of slab row 0, canvas column of slab col 0
  int R2, cy0;    // crop rows and the canvas row of the first
  int W3, cx0;    // crop columns and the canvas column of the first
};

template <int P>
__global__ void shear3_kernel(const float* __restrict__ slab,
                              float* __restrict__ out, float2* scratch,
                              const double* __restrict__ acoef,
                              const double* __restrict__ bcoef,
                              const float2* __restrict__ tw, Geometry g) {
  extern __shared__ float2 buf[];
  cg::grid_group grid = cg::this_grid();
  const long long fr = (long long)g.R1 * g.N;   // scratch frame stride
  for (int g0 = 0; g0 < g.B; g0 += g.G) {
    const int gb = min(g.G, g.B - g0);

    // stage 1: x-shear of the occupied rows, slab -> scratch rows
    for (int t = blockIdx.x; t < gb * g.R1; t += gridDim.x) {
      const int f = t / g.R1, r = t % g.R1, b = g0 + f;
      vip::shear_line<true, false, P, true>(
          buf, slab, b * g.in_sb + r * g.in_sl, 1, g.W1, g.px0, scratch,
          f * fr + (long long)r * g.N, 1, g.N, 0, acoef[b], g.py0 + r, tw,
          g.N, g.logM);
      __syncthreads();
    }
    grid.sync();

    // stage 2: y-shear of every column, in place
    for (int t = blockIdx.x; t < gb * g.N; t += gridDim.x) {
      const int f = t / g.N, col = t % g.N, b = g0 + f;
      vip::shear_line<false, false, P, false>(
          buf, scratch, f * fr + col, g.N, g.R1, g.py0, scratch,
          f * fr + col, g.N, g.R2, g.cy0, bcoef[b], col, tw, g.N, g.logM);
      __syncthreads();
    }
    grid.sync();

    // stage 3: x-shear of the crop rows, scratch -> real output
    for (int t = blockIdx.x; t < gb * g.R2; t += gridDim.x) {
      const int f = t / g.R2, r = t % g.R2, b = g0 + f;
      vip::shear_line<false, true, P, false>(
          buf, scratch, f * fr + (long long)r * g.N, 1, g.N, 0, out,
          ((long long)b * g.R2 + r) * g.W3, 1, g.W3, g.cx0, acoef[b],
          g.cy0 + r, tw, g.N, g.logM);
      __syncthreads();
    }
    grid.sync();
  }
}

}  // namespace

// Rotate B frames with the three shears in one cooperative launch.
// slab: (B, R1 rows of W1 floats) at strides in_sb, in_sl; its row r is
// canvas row py0 + r, its column j canvas column px0 + j. scratch: G x R1
// x N complex64. out: (B, R2, W3) float, canvas rows cy0.., columns cx0...
// acoef/bcoef: float64 shear coefficients per frame; tw: exp(-2*pi*i*t/N),
// t < N, as complex64. Returns the CUDA error code: cudaErrorInvalidValue
// for a canvas or geometry it does not take, cudaErrorCooperativeLaunchTooLarge
// and the like from the launch, else cudaGetLastError().
extern "C" int vip_shear3(const float* slab, float* out, void* scratch,
                          const double* acoef, const double* bcoef,
                          const void* tw, int B, int G, int N,
                          long long in_sb, long long in_sl, int R1, int W1,
                          int py0, int px0, int R2, int cy0, int W3, int cx0,
                          void* stream) {
  int p, logM;
  vip::canvas_factors(N, &p, &logM);
  if (p == 0 || B < 1 || G < 1 || R1 < 1 || R2 < 1 || W3 < 1 ||
      R2 > R1 || py0 < 0 || cy0 < 0 || cx0 < 0 || px0 < 0 ||
      px0 + W1 > N || py0 + R1 > N || cy0 + R2 > N || cx0 + W3 > N)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  Geometry g{B, G, N, logM, in_sb, in_sl, R1, W1, py0, px0, R2, cy0, W3, cx0};
  const int threads = N / 2 < 256 ? N / 2 : 256;
  size_t smem = (size_t)N * sizeof(float2);
  const float2* twc = static_cast<const float2*>(tw);
  float2* scr = static_cast<float2*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {(void*)&slab, (void*)&out, (void*)&scr, (void*)&acoef,
                  (void*)&bcoef, (void*)&twc, (void*)&g};
#define VIP_COOP(PP)                                                         \
  {                                                                          \
    int per_sm = 0;                                                          \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
        &per_sm, shear3_kernel<PP>, threads, smem);                          \
    if (err != cudaSuccess) return (int)err;                                 \
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;          \
    err = cudaLaunchCooperativeKernel((void*)shear3_kernel<PP>,              \
                                      dim3(per_sm * sms), dim3(threads),     \
                                      args, smem, s);                        \
    if (err != cudaSuccess) return (int)err;                                 \
  }
  VIP_SWITCH_P(p, VIP_COOP)
#undef VIP_COOP
  return (int)cudaGetLastError();
}
