// The sanitizing instantiation of the decode design, whose kernel and
// launcher are grmac_decode.cuh; grmac_decode.cu compiles the plain
// one, each by its own nvcc process, in parallel.
#include "grmac_decode.cuh"

namespace grmac {

cudaError_t launch_decode_san(const Params& p, int n_r, int granularity,
                             cudaStream_t stream) {
  return launch_decode_t<true>(p, n_r, granularity, stream);
}

}  // namespace grmac
