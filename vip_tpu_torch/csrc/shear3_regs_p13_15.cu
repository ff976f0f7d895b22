// H4's cooperative kernel on the register engine (csrc/shear3_regs.cuh)
// for the odd canvas factors p = 13 and 15: one source of four, so that nvcc
// builds them in parallel (vip_tpu_torch/_build.py).

#include "shear3_regs.cuh"

namespace vip {
template int launch_shear3<13>(const Shear3Args&, int, cudaStream_t, int*);
template int launch_shear3<15>(const Shear3Args&, int, cudaStream_t, int*);
}  // namespace vip
