// The inverse transform (the stage's and K7's) of the large-axis kernel (stage_large.cuh), compiled apart from
// the other modes so that nvcc builds them side by side; the C entry point
// is in stage_large.cu.

#include "stage_large.cuh"

namespace ipplarge {

cudaError_t launch_inv(bool natural, IPP_LARGE_LAUNCH_ARGS) {
  return natural ? launch_large<INV, true>(IPP_LARGE_PASS_ARGS)
                 : launch_large<INV, false>(IPP_LARGE_PASS_ARGS);
}

}  // namespace ipplarge
