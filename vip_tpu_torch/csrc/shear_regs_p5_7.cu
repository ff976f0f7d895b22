// The register engine's kernels (csrc/shear_regs.cuh) for the odd canvas
// factors p = 5 and 7: one source of four, so that nvcc builds them
// in parallel (vip_tpu_torch/_build.py).

#include "shear_regs.cuh"

namespace vip {
template int launch_regs<5>(const RegArgs&, cudaStream_t);
template int launch_regs<7>(const RegArgs&, cudaStream_t);
}  // namespace vip
