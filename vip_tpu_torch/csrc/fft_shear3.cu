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
// fori-loop blocking are not carried over. Each line is sheared by the
// engine H2 and H3 run on the same canvas (a pure function of N,
// `ops.shear.register_engine_takes`): the register engine
// `vip::shear_line_regs` (shear_regs.cuh, kernel in shear3_regs.cuh) for
// N <= 2048, the radix-2 body `vip::shear_line` (shear_line.cuh, kernel
// below) above. With the same plan, tables, float64 coefficients and phase
// reduction, H4 computes H2's and H3's arithmetic line for line.
//
// Design. The intermediate band of one 512^2 frame is (y+1) x N complex64
// = 513 x 2048 x 8 B = 8.4 MB: more than a block's 227 KB of shared memory
// or a cluster's. So the launch is persistent and cooperative: the grid is
// as large as can be co-resident (occupancy x SMs,
// cudaLaunchCooperativeKernel refuses anything larger), and it walks the
// batch in groups of G frames whose scratch (G x R1 x N complex64) the
// wrapper allocates (ops.shear._fused3_group: a whole chunk by default; a
// group small enough to stay in the 50 MB L2 measured slower). Per group:
//   stage 1  the x-shear of the R1 band rows of the group's frames, each
//            frame read in place as the rot90 of its quadrant (rot90_row,
//            shear_regs.cuh; no placed slab or extended canvas exists)
//            -> full rows of the scratch;
//   grid.sync()
//   stage 2  the y-shear of the N columns: each column's R1 band rows ->
//            its R2 crop rows, written IN PLACE into the same column of
//            the scratch (a block owns whole columns and loads them all
//            before it stores, so nothing else reads them);
//   grid.sync()
//   stage 3  the x-shear of the R2 crop rows -> the real output columns
//            [cx0, cx0 + W3);
//   grid.sync()  (the next group reuses the scratch)
// The register engine takes `group` lines a block in every stage (one
// block size for the launch): rows as H2's row kernels hold them, columns
// in groups of C = group adjacent columns as H2's column kernel, thread
// c + C*t holding column c from row t, so that a warp's scratch accesses
// cover whole 32-byte sectors. group = 4 * max(1, 64 / T), T = N / 16: 4
// lines of 512 threads at N = 2048, 4 lines of 160 at N = 640. The radix-2
// body takes one line a block of 256 threads.
// Scratch is read with ld.global.cg (the engine's load policy NC = false):
// blocks of the same launch wrote it, and the non-coherent read-only path
// could serve a stale line of the previous group. The frames, tables and
// coefficients are read through the read-only path.
//
// What bounds it on this card: as H2, the line arithmetic of the engine
// (5 N log2 N flop a complex FFT each way, 0.55 ms at the float32 peak for
// 50 frames of 512^2), not the scratch traffic. Each stage of a group
// starts with every block loading at once and ends with the blocks
// waiting at the grid barrier for the last iteration; with few block
// iterations a stage (4 frames a group: 4 to 16) those ramps cost more
// than keeping the scratch in L2 saves (PERF.md), hence one group a chunk.

#include "shear3_regs.cuh"

namespace {

// The radix-2 body in one cooperative launch (N > 2048): one line a block
// iteration, the stages and groups as the register kernel's.
template <int P>
__global__ void shear3_radix2_kernel(const vip::Shear3Args a) {
  extern __shared__ float2 buf[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long fr = (long long)a.R1 * a.N;
  const long long fy = (long long)a.y * a.y;
  int st = 0;
  vip::stamp(a.stamps, st++);
  for (int g0 = 0; g0 < a.B; g0 += a.G) {
    const int gb = min(a.G, a.B - g0);
    for (int it = blockIdx.x; it < gb * a.R1; it += gridDim.x) {
      const int f = it / a.R1, r = it % a.R1, b = g0 + f;
      const vip::RowIn in = vip::rot90_row((int)(a.quad[b] & 3), r, a.y,
                                           b * fy, a.y, 1, a.px0);
      vip::shear_line<true, false, P, true>(
          buf, a.frames, in.base, in.step, in.len, in.off, a.scratch,
          f * fr + (long long)r * a.N, 1, a.N, 0, a.acoef[b], a.py0 + r,
          a.tw, a.N, a.logM);
      __syncthreads();
    }
    grid.sync();
    vip::stamp(a.stamps, st++);
    for (int it = blockIdx.x; it < gb * a.N; it += gridDim.x) {
      const int f = it / a.N, col = it % a.N;
      vip::shear_line<false, false, P, false>(
          buf, a.scratch, f * fr + col, a.N, a.R1, a.py0, a.scratch,
          f * fr + col, a.N, a.R2, a.cy0, a.bcoef[g0 + f], col, a.tw, a.N,
          a.logM);
      __syncthreads();
    }
    grid.sync();
    vip::stamp(a.stamps, st++);
    for (int it = blockIdx.x; it < gb * a.R2; it += gridDim.x) {
      const int f = it / a.R2, r = it % a.R2, b = g0 + f;
      vip::shear_line<false, true, P, false>(
          buf, a.scratch, f * fr + (long long)r * a.N, 1, a.N, 0, a.out,
          ((long long)b * a.R2 + r) * a.W3, 1, a.W3, a.cx0, a.acoef[b],
          a.cy0 + r, a.tw, a.N, a.logM);
      __syncthreads();
    }
    grid.sync();
    vip::stamp(a.stamps, st++);
  }
}

// Check the geometry, then launch H4 (or report its configuration: `info`,
// vip::coop_launch) with the engine that N takes.
int shear3(const vip::Shear3Args& a0, cudaStream_t s, int* info) {
  vip::Shear3Args a = a0;
  int p;
  vip::canvas_factors(a.N, &p, &a.logM);
  const bool regs = a.N <= vip::kRegMaxN;
  if (p == 0 || a.B < 1 || a.G < 1 || a.y < 1 || a.R1 < 1 || a.R2 < 1 ||
      a.W3 < 1 || a.R1 > a.y + 1 || a.R2 > a.R1 || a.py0 < 0 ||
      a.px0 < 0 || a.cy0 < 0 || a.cx0 < 0 || a.py0 + a.R1 > a.N ||
      a.cy0 + a.R2 > a.N || a.cx0 + a.W3 > a.N ||
      (regs && (a.ptw == nullptr || a.freq == nullptr || a.group < 4 ||
                a.group % 4 != 0 ||
                a.group * (a.N >> 4) > vip::kRegMaxThreads)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  if (regs) {
#define VIP_REGS(PP) return vip::launch_shear3<PP>(a, sms, s, info)
    VIP_SWITCH_P(p, VIP_REGS)
#undef VIP_REGS
  }
  static size_t granted[16];  // radix-2: at most 32 KB, never above 48 KB
  const size_t smem = (size_t)a.N * sizeof(float2);
#define VIP_RADIX2(PP)                                                       \
  return vip::coop_launch(shear3_radix2_kernel<PP>, a, 256, smem, granted,  \
                          sms, s, info)
  VIP_SWITCH_P(p, VIP_RADIX2)
#undef VIP_RADIX2
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Rotate B frames with the three shears in one cooperative launch.
// frames: (B, y, y) float, contiguous, read as the rot90 of quadrant
// quad[b] (int64 per frame). Stage 1 shears R1 rows (R1 <= y + 1; row r is
// canvas row py0 + r, the turned frame's column 0 at canvas column px0 and
// one row down / one column right per quadrant as rot90_row places it).
// scratch: G x R1 x N complex64. out: (B, R2, W3) float, canvas rows
// cy0.., columns cx0... acoef/bcoef: float64 shear coefficients per frame;
// tw: exp(-2*pi*i*t/N), t < N, as complex64; for N <= 2048 also the
// register engine's pass twiddles `ptw` and frequency table `freq`
// (shear_regs.cuh) and `group`, the lines a block (a multiple of 4, group
// * N / 16 <= 512); above, the radix-2 body ignores all three. stamps: null,
// or 1 + 3 * ceil(B / G) uint64 for block 0's %globaltimer at the start and
// after each grid barrier. Returns the CUDA error code:
// cudaErrorInvalidValue for a canvas or geometry it does not take,
// cudaErrorCooperativeLaunchTooLarge and the like from the launch, else
// cudaGetLastError().
extern "C" int vip_shear3(const float* frames, const void* quad, float* out,
                          void* scratch, const double* acoef,
                          const double* bcoef, const void* tw,
                          const void* ptw, const void* freq, int B, int G,
                          int group, int N, int y, int R1, int py0, int px0,
                          int R2, int cy0, int W3, int cx0, void* stamps,
                          void* stream) {
  if (quad == nullptr) return (int)cudaErrorInvalidValue;
  const vip::Shear3Args a{frames,
                          static_cast<const long long*>(quad),
                          out,
                          static_cast<float2*>(scratch),
                          acoef,
                          bcoef,
                          static_cast<const float2*>(tw),
                          static_cast<const float2*>(ptw),
                          static_cast<const int*>(freq),
                          B, G, group, N, 0, y, R1, py0, px0, R2, cy0, W3,
                          cx0,
                          static_cast<unsigned long long*>(stamps)};
  return shear3(a, (cudaStream_t)stream, nullptr);
}

// H4's launch configuration on a canvas of N points with `group` lines a
// block (ignored above N = 2048), without launching: info[0..5] = registers
// a thread, spilled (local) bytes a thread, blocks an SM, grid, threads a
// block, dynamic shared memory a block. Returns a CUDA error code.
extern "C" int vip_shear3_info(int N, int group, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  // non-null stand-ins for the tables, which nothing reads without a launch
  const float2* tables = reinterpret_cast<const float2*>(info);
  const vip::Shear3Args a{nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, tables, tables,
                          reinterpret_cast<const int*>(info),
                          1, 1, group, N, 0, N, 1, 0, 0, 1, 0, 1, 0,
                          nullptr};
  return shear3(a, nullptr, info);
}
