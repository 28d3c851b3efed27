// The stage markers of the port's spans (repro_torch/core/spans.py): one
// no-op kernel, one instance a stage, so that a profiler's trace names the
// stage.  A CUDA graph captured while tracing is on records a marker at each
// stage's entry of its round or wave body and one at the body's end; on the
// device clock every operation of a replay then follows the marker of its
// stage.  No Pallas kernel of the reference is ported here: the marker does
// no work, reads and writes nothing, and launches one thread.
//
// The instances in the order of span_mark's switch, which is spans.MARKS'.

#include <cuda_runtime.h>

namespace rew {
struct merge;
struct sweep;
struct dedup;
struct join;
struct flags;
}  // namespace rew
namespace maint {
struct tomb_join;
struct od_step;
}  // namespace maint
namespace body {
struct end;
}  // namespace body

template <class Stage>
__global__ void __launch_bounds__(1, 1) span_mark_kernel() {}

template <class Stage>
static int launch(cudaStream_t s) {
  span_mark_kernel<Stage><<<1, 1, 0, s>>>();
  return (int)cudaGetLastError();
}

// stage: an index of spans.MARKS; stream: the caller's current stream.
extern "C" int span_mark(int stage, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 0: return launch<rew::merge>(s);
    case 1: return launch<rew::sweep>(s);
    case 2: return launch<rew::dedup>(s);
    case 3: return launch<rew::join>(s);
    case 4: return launch<rew::flags>(s);
    case 5: return launch<maint::tomb_join>(s);
    case 6: return launch<maint::od_step>(s);
    case 7: return launch<body::end>(s);
    default: return (int)cudaErrorInvalidValue;
  }
}
