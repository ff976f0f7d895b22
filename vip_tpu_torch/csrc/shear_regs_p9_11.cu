// The register engine's kernels (csrc/shear_regs.cuh) for the odd canvas
// factors p = 9 and 11: one source of four, so that nvcc builds them
// in parallel (vip_tpu_torch/_build.py).

#include "shear_regs.cuh"

namespace vip {
template int launch_regs<9>(const RegArgs&, cudaStream_t);
template int launch_regs<11>(const RegArgs&, cudaStream_t);
}  // namespace vip
