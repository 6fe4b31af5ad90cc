"""Device policy of the port.

Entry points run on CUDA unless the caller asks for the CPU. There is no
fallback: asking for CUDA on a machine without it raises.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` ("cuda", "cuda:N", "cpu" or a torch.device) -> torch.device.

    Raises RuntimeError when a CUDA device is asked for and CUDA is
    absent; the CPU is used only when it is asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
