// The inverse stage with the OTF product (K4, K4b) of the large-axis kernel (stage_large.cuh), compiled apart from
// the other modes so that nvcc builds them side by side; the C entry point
// is in stage_large.cu.

#include "stage_large.cuh"

namespace ipplarge {

cudaError_t launch_inv_otf(IPP_LARGE_LAUNCH_ARGS) {
  return launch_large<INV_OTF, false>(IPP_LARGE_PASS_ARGS);
}

}  // namespace ipplarge
