// The register engine's kernels (csrc/shear_regs.cuh) for the odd canvas
// factors p = 13 and 15: one source of four, so that nvcc builds them
// in parallel (vip_tpu_torch/_build.py).

#include "shear_regs.cuh"

namespace vip {
template int launch_regs<13>(const RegArgs&, cudaStream_t);
template int launch_regs<15>(const RegArgs&, cudaStream_t);
}  // namespace vip
