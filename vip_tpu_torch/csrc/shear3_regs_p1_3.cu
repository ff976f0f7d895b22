// H4's cooperative kernel on the register engine (csrc/shear3_regs.cuh)
// for the odd canvas factors p = 1 and 3: one source of four, so that nvcc
// builds them in parallel (vip_tpu_torch/_build.py).

#include "shear3_regs.cuh"

namespace vip {
template int launch_shear3<1>(const Shear3Args&, int, cudaStream_t, int*);
template int launch_shear3<3>(const Shear3Args&, int, cudaStream_t, int*);
}  // namespace vip
