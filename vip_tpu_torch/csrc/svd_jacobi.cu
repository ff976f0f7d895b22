// K5: the thin SVD of a batch of small float32 matrices (both sides <= 64)
// by one-sided (Hestenes) Jacobi, one block a matrix, for Hopper (sm_90a).
//
// K5 replaces no TPU kernel: vip_tpu leaves every SVD to XLA. It replaces
// cuSOLVER's gesvd where the port's PCA factors many small matrices: the
// ADI+mSDI double pass (`psfsub/pca_fullfr.py`, `_adimsdi_doublepca_ifs`)
// takes the SVD of the 39x39 R factor of each of 100 frames' spectral
// matrices. PyTorch runs a batched CUDA gesvd as one cuSOLVER call a
// matrix; each call launched about 1,100 kernels and copied its info word
// back to the host, so that loop left the H100 idle about 0.6 s of a 1.18 s
// request and took some 200 ms of tiny kernels (111,290 kernels a request;
// the benchmark's cell `ifs290.pca_double`, traced). cuSOLVER's
// batched Jacobi takes only matrices up to 32x32, and the Jacobi `gesvdj`
// put the float32 PCA 110x farther from VIP's frames (ROADMAP F2).
//
// What bounds it: not the work (a 39x39 matrix takes 4-13 sweeps of 741
// rotations of some 700 flop each, at most 7 Mflop, microseconds over a
// wave of blocks) nor the bytes (6 KB in, 12 KB out a matrix) but the
// chain of dependent steps: a sweep is K - 1 steps, each ending in a
// barrier, 156-507 barriers for a 39x39 matrix. So one block holds one
// matrix (100 blocks: one wave of the 132 SMs), every pair of a step is
// rotated at once by its own warp, and nothing leaves shared memory until
// the end; the launch replaces ~110,000 launches and 100 host round trips.
//
// The algorithm (the plain version is `ops/linalg.py`, `svd_jacobi_plain`):
//   - the block holds the matrix with its columns along the short side (A
//     when m >= n, A^T otherwise): k = min(m, n) columns of L = max(m, n),
//     in float64 in shared memory, beside the k x k product of the
//     rotations (from the identity), column after column. A warp reads a
//     column as 2 consecutive doubles a lane: no bank conflicts;
//   - round-robin ordering: K = k rounded up to even (a dummy column pads
//     an odd k), K - 1 steps a sweep, each of K / 2 disjoint pairs: pair p
//     of step r is (P[p], P[K-1-p]) with P[0] = 0 and P[x] = (x-1+r) %
//     (K-1) + 1; warp p takes pair p;
//   - each warp forms |a_i|^2, |a_j|^2 and a_i . a_j with xor-shuffle
//     reductions (every lane ends with the same bits: each level adds the
//     same two values), and where |a_i . a_j| > eps |a_i| |a_j| (float32's
//     eps) applies Rutishauser's rotation, t = sign(z) / (|z| + hypot(1,
//     z)), z = (|a_j|^2 - |a_i|^2) / (2 a_i . a_j), to both columns and to
//     the two columns of the rotations;
//   - sweeps stop after the first that rotates no pair, or after kMaxSweeps;
//   - the singular values are the columns' norms, ranked in descending
//     order (ties by column) by one thread a column; the columns over
//     their norms are the singular vectors on the long side, and the
//     rotations those on the short side (a NaN norm ranks last). A column
//     of norm 0 is completed by warp 0 to a unit vector orthogonal to all
//     others (the unit vector of the row of least norm, less its
//     projections, twice).
// float64 inside: with float32 sums the rounding of a_i . a_j is itself
// about eps |a_i| |a_j|, so the stopping rule would not be met on some
// pairs and rank-deficient matrices would sweep to the cap; the float64
// arithmetic costs nothing that shows beside the barriers.
//
// Outputs as torch.linalg.svd(A, full_matrices=False): U (m, k), S (k), Vh
// (k, n) a matrix, row-major, float32; info[b] = sweeps taken, or -1 where
// no sweep was quiet within the cap or a singular value is not finite.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxSide = 64;
// the cap of a non-converging loop (LAPACK's sgesvj stops at 30 too); a
// random 64x64 matrix converges in about 10 sweeps, the double pass's
// graded 39x39 R factors in 4
constexpr int kMaxSweeps = 30;
constexpr double kTol = 1.1920928955078125e-07;  // float32's epsilon, 2^-23

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__global__ void __launch_bounds__(1024)
    svd_jacobi_kernel(const float* __restrict__ a, float* __restrict__ u,
                      float* __restrict__ s, float* __restrict__ vh,
                      int* __restrict__ info, int m, int n) {
  extern __shared__ double smem[];
  __shared__ int rotated, nulls;
  const int k = min(m, n), L = max(m, n), K = k + (k & 1);
  const bool tall = m >= n;
  double* W = smem;             // k columns of L
  double* V = W + k * L;        // k columns of k: the rotations
  double* sig = V + k * k;      // k norms
  int* rank = (int*)(sig + k);  // k ranks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const size_t b = blockIdx.x;
  const float* A = a + b * m * n;

  for (int e = tid; e < m * n; e += nthreads) {
    const int r = e / n, c = e - r * n;
    W[tall ? c * L + r : r * L + c] = (double)A[e];
  }
  for (int e = tid; e < k * k; e += nthreads)
    V[e] = (e / k == e % k) ? 1.0 : 0.0;
  if (tid == 0) nulls = 0;
  __syncthreads();

  int sweep = 0;
  bool quiet = false;
  while (!quiet && sweep < kMaxSweeps) {
    ++sweep;
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (int step = 0; step < K - 1; ++step) {
      const int i = warp == 0 ? 0 : (warp - 1 + step) % (K - 1) + 1;
      const int j = (K - 2 - warp + step) % (K - 1) + 1;
      if (i < k && j < k) {
        double* ci = W + i * L;
        double* cj = W + j * L;
        const bool l0 = lane < L, l1 = lane + 32 < L;
        const double x0 = l0 ? ci[lane] : 0.0, x1 = l1 ? ci[lane + 32] : 0.0;
        const double y0 = l0 ? cj[lane] : 0.0, y1 = l1 ? cj[lane + 32] : 0.0;
        const double alpha = warp_sum(x0 * x0 + x1 * x1);
        const double beta = warp_sum(y0 * y0 + y1 * y1);
        const double gamma = warp_sum(x0 * y0 + x1 * y1);
        // the same bits on every lane: the branch is warp-uniform
        if (fabs(gamma) > kTol * sqrt(alpha) * sqrt(beta)) {
          const double zeta = (beta - alpha) / (2.0 * gamma);
          const double t =
              copysign(1.0, zeta) / (fabs(zeta) + hypot(1.0, zeta));
          const double c = 1.0 / sqrt(1.0 + t * t), sn = c * t;
          if (l0) {
            ci[lane] = c * x0 - sn * y0;
            cj[lane] = sn * x0 + c * y0;
          }
          if (l1) {
            ci[lane + 32] = c * x1 - sn * y1;
            cj[lane + 32] = sn * x1 + c * y1;
          }
          double* vi = V + i * k;
          double* vj = V + j * k;
          for (int r = lane; r < k; r += 32) {
            const double p = vi[r], q = vj[r];
            vi[r] = c * p - sn * q;
            vj[r] = sn * p + c * q;
          }
          if (lane == 0) rotated = 1;
        }
      }
      __syncthreads();
    }
    quiet = !rotated;
    __syncthreads();  // every thread has read `rotated` before its reset
  }

  for (int c = warp; c < k; c += nwarps) {
    const double* col = W + c * L;
    const double x0 = lane < L ? col[lane] : 0.0;
    const double x1 = lane + 32 < L ? col[lane + 32] : 0.0;
    const double nn = warp_sum(x0 * x0 + x1 * x1);
    if (lane == 0) sig[c] = sqrt(nn);
  }
  __syncthreads();
  if (tid < k) {
    // a NaN norm ranks last (key -1), so the ranks are a permutation
    const double me = isnan(sig[tid]) ? -1.0 : sig[tid];
    int r = 0;
    for (int c = 0; c < k; ++c) {
      const double other = isnan(sig[c]) ? -1.0 : sig[c];
      r += other > me || (other == me && c < tid);
    }
    rank[tid] = r;
    if (me == 0.0) atomicAdd(&nulls, 1);
  }
  __syncthreads();
  for (int e = tid; e < k * L; e += nthreads) {
    const double d = sig[e / L];
    if (d != 0.0) W[e] /= d;
  }
  __syncthreads();

  if (nulls && warp == 0) {
    // complete the zero columns, in column order, to an orthonormal set
    for (int c = 0; c < k; ++c) {
      if (sig[c] != 0.0) continue;
      double best = 0.0;
      int t = -1;
      for (int r = 0; r < L; ++r) {
        double part = 0.0;
        for (int q = lane; q < k; q += 32)
          if (sig[q] != 0.0 || q < c) part += W[q * L + r] * W[q * L + r];
        const double rn = warp_sum(part);
        if (t < 0 || rn < best) {
          best = rn;
          t = r;
        }
      }
      double v0 = lane == t ? 1.0 : 0.0, v1 = lane + 32 == t ? 1.0 : 0.0;
      for (int pass = 0; pass < 2; ++pass)
        for (int q = 0; q < k; ++q) {
          if (sig[q] == 0.0 && q >= c) continue;
          const double* col = W + q * L;
          const double w0 = lane < L ? col[lane] : 0.0;
          const double w1 = lane + 32 < L ? col[lane + 32] : 0.0;
          const double d = warp_sum(w0 * v0 + w1 * v1);
          v0 -= d * w0;
          v1 -= d * w1;
        }
      const double nv = sqrt(warp_sum(v0 * v0 + v1 * v1));
      if (lane < L) W[c * L + lane] = v0 / nv;
      if (lane + 32 < L) W[c * L + lane + 32] = v1 / nv;
      __syncwarp();
    }
  }
  __syncthreads();

  // U (m, k), Vh (k, n): the long side's vectors come from W, the short
  // side's from V
  float* Ub = u + b * m * k;
  float* Vb = vh + b * k * n;
  for (int e = tid; e < m * k; e += nthreads) {
    const int r = e / k, c = e - r * k;  // row r of column c, to rank[c]
    Ub[r * k + rank[c]] = (float)(tall ? W[c * L + r] : V[c * k + r]);
  }
  for (int e = tid; e < k * n; e += nthreads) {
    const int c = e / n, col = e - c * n;  // column c's element col
    Vb[rank[c] * n + col] = (float)(tall ? V[c * k + col] : W[c * L + col]);
  }
  if (tid < k) s[b * k + rank[tid]] = (float)sig[tid];
  if (tid == 0) {
    bool finite = true;
    for (int c = 0; c < k; ++c) finite = finite && isfinite(sig[c]);
    info[b] = quiet && finite ? sweep : -1;
  }
}

size_t smem_bytes(int m, int n) {
  const int k = m < n ? m : n, L = m < n ? n : m;
  return (size_t)(k * L + k * k + k) * sizeof(double) + (size_t)k * sizeof(int);
}

}  // namespace

// The SVD of `batch` row-major (m, n) float32 matrices at `a`, into U (m,
// k), S (k) and Vh (k, n) a matrix and info (one int a matrix), on
// `stream`. Returns a CUDA error code (0: launched).
extern "C" int vip_svd_jacobi(const float* a, float* u, float* s, float* vh,
                              int* info, long long batch, int m, int n,
                              void* stream) {
  if (m < 1 || n < 1 || m > kMaxSide || n > kMaxSide || batch < 1 ||
      batch > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int k = m < n ? m : n;
  const int threads = 32 * ((k + 1) / 2);
  const size_t smem = smem_bytes(m, n);
  cudaError_t err = cudaFuncSetAttribute(
      svd_jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  svd_jacobi_kernel<<<(unsigned)batch, threads, smem, (cudaStream_t)stream>>>(
      a, u, s, vh, info, m, n);
  return (int)cudaGetLastError();
}
