"""Device policy of the port.

Entry points run on CUDA unless the caller asks for the CPU. There is no
fallback: asking for CUDA on a machine without it raises.
"""

import subprocess

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


def card_line(device):
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (its first card) for a
    CUDA device, or "cpu"; without a readable nvidia-smi, the device's
    name alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is None or out.returncode != 0 or not out.stdout.strip():
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return out.stdout.strip().splitlines()[0]
