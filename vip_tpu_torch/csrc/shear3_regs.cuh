// H4 on the register engine: the three shears of a rotation in one
// cooperative launch, each line sheared by vip::shear_line_regs
// (shear_regs.cuh), for canvases N <= 2048. csrc/fft_shear3.cu gives the
// design and holds the C entry; each odd factor p of the canvas is
// instantiated in one of the csrc/shear3_regs_p*.cu sources, so that nvcc
// builds them in parallel.

#pragma once

#include <cooperative_groups.h>

#include "shear_regs.cuh"

namespace vip {

// One H4 launch, as vip_shear3 (fft_shear3.cu) checked it. The frames are
// B contiguous y x y images; the scratch holds G frames' (R1, N) complex64
// bands; the output is (B, R2, W3). Stage 1 reads row r < R1 (canvas row
// py0 + r) of frame b as its rot90 of quadrant quad[b] (rot90_row), column
// 0 at canvas px0; stage 2 shears the N columns from their R1 band rows
// (canvas rows py0..) to the R2 crop rows (canvas rows cy0..), in place;
// stage 3 shears the R2 crop rows to the W3 output columns (canvas columns
// cx0..). `group` lines a block in every stage (T = N / 16 threads a
// line). `stamps`, if not null, gets the %globaltimer of block 0 at the
// start and after every grid barrier (1 + 3 * groups of frames entries).
struct Shear3Args {
  const float* frames;
  const long long* quad;
  float* out;
  float2* scratch;
  const double* acoef;
  const double* bcoef;
  const float2* tw;
  const float2* ptw;
  const int* freq;
  int B, G, group, N, logM, y, R1, py0, px0, R2, cy0, W3, cx0;
  unsigned long long* stamps;
};

__device__ __forceinline__ void stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    stamps[i] = ns;
  }
}

// The occupancy of a cooperative kernel with `threads` threads and `smem`
// bytes of dynamic shared memory a block, after granting that shared
// memory above 48 KB (once per kernel and device, `granted` the kernel's
// own). Returns a CUDA error code; a kernel that cannot hold one block an
// SM gives cudaErrorCooperativeLaunchTooLarge.
template <typename Kernel>
int coop_occupancy(Kernel kernel, int threads, size_t smem, size_t* granted,
                   int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  if (smem > (size_t)(48 << 10) && granted[dev] < smem) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  return *per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// Launch `kernel` cooperatively over `per_sm` x `sms` blocks, or, with
// `info`, launch nothing and report the configuration: registers a thread,
// local (spilled) bytes a thread, blocks an SM, grid, threads a block and
// dynamic shared memory a block.
template <typename Kernel, typename Args>
int coop_launch(Kernel kernel, const Args& a, int threads, size_t smem,
                size_t* granted, int sms, cudaStream_t stream, int* info) {
  int per_sm = 0;
  int rc = coop_occupancy(kernel, threads, smem, granted, &per_sm);
  if (rc != 0) return rc;
  if (info != nullptr) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
    if (err != cudaSuccess) return (int)err;
    info[0] = fa.numRegs;
    info[1] = (int)fa.localSizeBytes;
    info[2] = per_sm;
    info[3] = per_sm * sms;
    info[4] = threads;
    info[5] = (int)smem;
    return 0;
  }
  void* args[] = {(void*)&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(per_sm * sms), dim3(threads), args, smem,
      stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

namespace {

// The three stages, the grid walking the batch in groups of G frames. In
// each stage a block iteration `it` takes `group` lines of one frame of
// the group: frame it / nb, lines (it % nb) * group + slot. Every block
// makes the same iterations' calls with all its threads, active or not,
// so that the engine's barriers are reached by all.
template <int P>
__global__ void __launch_bounds__(kRegMaxThreads)
    shear3_regs_kernel(const Shear3Args a) {
  extern __shared__ float2 smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int T = a.N >> 4;
  const int stride = reg_line_stride(a.N);
  // rows (stages 1 and 3): thread l*T + t holds row l of the block's rows
  // from point t; columns (stage 2): thread c + group*tc holds column c
  // from row tc, so a warp's accesses cover whole 32-byte sectors
  const int l = threadIdx.x / T;
  const int t = threadIdx.x - l * T;
  const int c = threadIdx.x % a.group;
  const int tc = threadIdx.x / a.group;
  const long long fr = (long long)a.R1 * a.N;  // scratch frame stride
  const long long fy = (long long)a.y * a.y;   // input frame stride
  const int nb1 = ceil_div(a.R1, a.group);
  const int nb2 = ceil_div(a.N, a.group);
  const int nb3 = ceil_div(a.R2, a.group);
  int st = 0;
  stamp(a.stamps, st++);
  for (int g0 = 0; g0 < a.B; g0 += a.G) {
    const int gb = min(a.G, a.B - g0);

    // stage 1: x-shear of the band rows, the frames' rot90 read in place
    // -> full rows of the scratch
    for (int it = blockIdx.x; it < gb * nb1; it += gridDim.x) {
      const int f = it / nb1;
      const int r = (it - f * nb1) * a.group + l;
      const int b = g0 + f;
      const RowIn in = rot90_row((int)(a.quad[b] & 3), r, a.y, b * fy, a.y,
                                 1, a.px0);
      shear_line_regs<true, false, P>(
          smem + l * stride, a.frames, in.base, in.step, in.len, in.off,
          a.scratch, f * fr + (long long)r * a.N, 1, a.N, 0, a.acoef[b],
          a.py0 + r, a.tw, a.ptw, a.freq, a.N, a.logM, t, T, r < a.R1);
    }
    grid.sync();
    stamp(a.stamps, st++);

    // stage 2: y-shear of every column, band rows -> crop rows, in place
    // (a block loads its columns whole before it stores)
    for (int it = blockIdx.x; it < gb * nb2; it += gridDim.x) {
      const int f = it / nb2;
      const int col = (it - f * nb2) * a.group + c;
      const long long base = f * fr + col;
      shear_line_regs<false, false, P, false>(
          smem + c * stride, a.scratch, base, a.N, a.R1, a.py0, a.scratch,
          base, a.N, a.R2, a.cy0, a.bcoef[g0 + f], col, a.tw, a.ptw, a.freq,
          a.N, a.logM, tc, T, col < a.N);
    }
    grid.sync();
    stamp(a.stamps, st++);

    // stage 3: x-shear of the crop rows -> the real output columns
    for (int it = blockIdx.x; it < gb * nb3; it += gridDim.x) {
      const int f = it / nb3;
      const int r = (it - f * nb3) * a.group + l;
      const int b = g0 + f;
      shear_line_regs<false, true, P, false>(
          smem + l * stride, a.scratch, f * fr + (long long)r * a.N, 1, a.N,
          0, a.out, ((long long)b * a.R2 + r) * a.W3, 1, a.W3, a.cx0,
          a.acoef[b], a.cy0 + r, a.tw, a.ptw, a.freq, a.N, a.logM, t, T,
          r < a.R2);
    }
    grid.sync();  // the next group reuses the scratch
    stamp(a.stamps, st++);
  }
}

}  // namespace

// One H4 launch on the register engine for the odd factor P of the canvas
// (or, with `info`, its configuration; coop_launch).
template <int P>
int launch_shear3(const Shear3Args& a, int sms, cudaStream_t stream,
                  int* info) {
  static size_t granted[16];
  const int threads = a.group * (a.N >> 4);
  const size_t smem = (size_t)a.group * reg_line_stride(a.N) * sizeof(float2);
  return coop_launch(shear3_regs_kernel<P>, a, threads, smem, granted, sms,
                     stream, info);
}

extern template int launch_shear3<1>(const Shear3Args&, int, cudaStream_t,
                                     int*);
extern template int launch_shear3<3>(const Shear3Args&, int, cudaStream_t,
                                     int*);
extern template int launch_shear3<5>(const Shear3Args&, int, cudaStream_t,
                                     int*);
extern template int launch_shear3<7>(const Shear3Args&, int, cudaStream_t,
                                     int*);
extern template int launch_shear3<9>(const Shear3Args&, int, cudaStream_t,
                                     int*);
extern template int launch_shear3<11>(const Shear3Args&, int, cudaStream_t,
                                      int*);
extern template int launch_shear3<13>(const Shear3Args&, int, cudaStream_t,
                                      int*);
extern template int launch_shear3<15>(const Shear3Args&, int, cudaStream_t,
                                      int*);

}  // namespace vip
