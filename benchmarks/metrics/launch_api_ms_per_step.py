"""Host milliseconds a step in the runtime calls that launch kernels
(cudaLaunchKernel and its kin; a graph replay's cudaGraphLaunch, which
blocks while the device's queue is full, is not counted) in the profiled
call."""


def read(ctx):
    w = ctx["window"]
    return 1e3 * w.launch_api_s / w.steps if w.kernels else None
