// Device stage clock of the step's spans (ust_run_tpu_torch/utils/trace.py).
//
// One single-thread kernel, launched at each boundary of a clocked span on
// the caller's stream. It reads the GPU's nanosecond clock (%globaltimer)
// once the work queued before it on the stream has finished, and keeps the
// accounting of one row of an int64 accumulator on the device:
//   row[0]      the clock at the previous stamp of this row;
//   row[add]    += the time since that stamp (add >= 1: the slot of the
//               innermost open span; -1: no span was open, nothing added);
//   row[count]  += 1 (count >= 1: the span that this stamp closes; -1:
//               none);
// then row[0] = now. A stamp is one kernel rather than an event so that a
// launch recorded into a CUDA graph capture adds its stage times on the
// device at every replay, with no host accounting: an event node in a
// graph is overwritten by each replay. The host picks the row (one for
// launches recorded into a capture, one for launches that run eagerly) and
// the slots at launch time.
//
// Bound: 24 bytes read and written by one thread, about 1-2 us a launch,
// all of it the launch; ten a step.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes. The launch goes on the caller's stream and checks no
// argument; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_clock_kernel(int64_t* row, int add, int count) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int64_t t = static_cast<int64_t>(now);
  if (add > 0) row[add] += t - row[0];
  if (count > 0) row[count] += 1;
  row[0] = t;
}

}  // namespace

extern "C" int stage_clock_stamp(int64_t* row, int add, int count,
                                 void* stream) {
  stage_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      row, add, count);
  return static_cast<int>(cudaGetLastError());
}
