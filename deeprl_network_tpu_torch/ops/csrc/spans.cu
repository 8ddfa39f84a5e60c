// Span marks of the port's update (utils/spans.py): one-thread kernels that
// stamp the card's clock into a ring of stamps on the card.
//
// Replaces no TPU kernel. A CUDA graph replays an update with nothing
// running in Python, so the boundaries of the spans inside it (rollout, env
// step, backward, optimizer, ...) have to be device work captured into the
// graph. A mark reads %globaltimer (nanoseconds) and writes it at
// ring[(slot % rows) * cols + col], where slot is a counter on the card that
// the update's last mark advances. It is bound by its launch, about one graph
// node's time: one thread, one load and one or two stores.
//
// Each mark is a kernel of its own, named after its span and edge
// (span_env_begin, span_env_end), so that a profiler's trace of the card can
// be read by name without a table shared with the program. span_mark
// launches the one named; span_clock writes the clock once where it is told,
// for the host to bracket it with its own clock.

#include <cuda_runtime.h>

#include <cstring>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(unsigned long long* ring, unsigned long long* slot,
                                      int col, int cols, int rows, int advance) {
  const unsigned long long t = global_ns();
  const unsigned long long s = *slot;
  ring[(s % rows) * cols + col] = t;
  if (advance) *slot = s + 1;
}

}  // namespace

#define SPANS(X) \
  X(graph) X(update) X(rollout) X(step) X(comm) X(env) X(returns) X(backward) X(allreduce) \
      X(optimizer)

#define MARK(span, edge)                                                                       \
  extern "C" __global__ void span_##span##_##edge(unsigned long long* ring,                     \
                                                   unsigned long long* slot, int col, int cols, \
                                                   int rows, int advance) {                     \
    stamp(ring, slot, col, cols, rows, advance);                                               \
  }
#define MARKS(span) MARK(span, begin) MARK(span, end)
SPANS(MARKS)

extern "C" __global__ void span_clock(unsigned long long* out) { *out = global_ns(); }

namespace {

typedef void (*MarkKernel)(unsigned long long*, unsigned long long*, int, int, int, int);

struct Entry {
  const char* name;
  MarkKernel kernel;
};

#define ENTRIES(span) {"span_" #span "_begin", span_##span##_begin}, {"span_" #span "_end", span_##span##_end},
const Entry KERNELS[] = {SPANS(ENTRIES)};

}  // namespace

// Launches the mark kernel `name` on `stream`: 0, a cudaError, or -1 for a
// name that no kernel has.
extern "C" int span_mark(const char* name, void* ring, void* slot, int col, int cols, int rows,
                         int advance, void* stream) {
  for (const Entry& e : KERNELS) {
    if (std::strcmp(e.name, name) != 0) continue;
    void* args[] = {&ring, &slot, &col, &cols, &rows, &advance};
    const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(e.kernel), dim3(1),
                                             dim3(1), args, 0, static_cast<cudaStream_t>(stream));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  return -1;
}

// Writes the card's clock to `out` from `stream`.
extern "C" int span_clock_mark(void* out, void* stream) {
  span_clock<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
