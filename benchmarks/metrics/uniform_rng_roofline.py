"""The uniform-field kernel's share of its roofline (ops/rng.py,
csrc/uniform_rng.cu): the bytes it writes (two float32 fields of patch
x patch an image of the weak augmentation) over the HBM bandwidth, over
its mean device time a launch in the profiled call, in percent."""

KERNEL = "uniform_fields_kernel"


def read(ctx):
    peaks = ctx["peaks"]
    hits = [(n, s) for name, (n, s) in ctx["window"].by_kernel.items()
            if KERNEL in name]
    if peaks is None or not hits:
        return None
    count = sum(n for n, _ in hits)
    seconds = sum(s for _, s in hits)
    bound = ctx["uniform_rng_bytes"] / peaks["hbm_bytes_per_s"]
    return 100.0 * bound / (seconds / count)
