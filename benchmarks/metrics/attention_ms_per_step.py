"""Device milliseconds a step in the attention kernels of the pinned
backend (flash attention, ust_run_tpu_torch/ops/attention.py), forward
and backward, in the profiled call. Kernels matched by name in
`ctx["window"].by_kernel` (`NAMES`), as seen on the H100 (torch 2.11,
CUDA 12.8): `pytorch_flash::flash_fwd_kernel<...>` (forward),
`pytorch_flash::flash_bwd_dot_do_o_kernel<...>`,
`pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<...>` and
`pytorch_flash::flash_bwd_convert_dq_kernel<...>` (backward). The fill
that zeroes the deterministic backward's float32 query-gradient
accumulator (a `FillFunctor<float>` kernel, ~13 us a layer) carries no
such name and is left out. None where no such kernel ran."""

NAMES = ("flash_fwd", "flash_bwd")


def seconds_per_step(ctx):
    window = ctx["window"]
    hits = [s for name, (_, s) in window.by_kernel.items()
            if any(n in name for n in NAMES)]
    return sum(hits) / window.steps if hits else None


def read(ctx):
    s = seconds_per_step(ctx)
    return None if s is None else 1e3 * s
