// The sanitizing instantiation of the prefill design, whose kernel and
// launcher are grmac_prefill.cuh; grmac_prefill.cu compiles the plain
// one, each by its own nvcc process, in parallel.
#include "grmac_prefill.cuh"

namespace grmac {

cudaError_t launch_prefill_san(const Params& p, int n_r, int granularity,
                              cudaStream_t stream) {
  return launch_prefill_t<true>(p, n_r, granularity, stream);
}

}  // namespace grmac
