"""Multi-head attention softmax(q k^T / sqrt(d)) v, as TransUNet's encoder
computes it (models/transunet.py). The JAX package has no attention: this
is the port's own.

On a CUDA tensor it is F.scaled_dot_product_attention with its backend
pinned to flash attention (`BACKEND`): q, k and v in bf16 or float16 (the
model's autocast), head size a multiple of 8. A call the backend cannot
take raises, as sdpa_kernel makes it; nothing falls back to another
backend. With `torch.backends.cudnn.deterministic` set (the port's
`--deterministic 1`, engine/trainer.py:set_numerics) the flash backward
runs its deterministic variant, which sums the query gradient's
partial blocks in a fixed order instead of adding them with atomics:
torch enables it only under `torch.use_deterministic_algorithms`, so two
hooks on the backward's autograd node (`_pin_deterministic`) switch that
on for the node alone, with the uninitialised-memory fill off, and
restore both after it.

Measured on the H100 (torch 2.11): the default flash backward is not
bit-stable run to run (8 runs at 21 x 12 heads x 576 x 64 differ, and
807 of a TransUNet train state's leaves after three steps), the
deterministic one is (8 runs equal, the state after three steps equal
in every leaf); it costs 0.934 against 0.868 ms for that forward and
backward.

On the CPU it is the plain computation: the scores in float32, their
softmax, and its product with v.

Calls that ran (plain counts, as ops/grouped_bn.py keeps them, reset by
semisup/step.py:reset_counts): `launches` counts every call run outside a
CUDA graph capture, the CPU's included, and the calls a replayed graph
runs (added by semisup/step.py's StepGraph); `captured` counts the calls
recorded into a capture, which run only on replay.
"""

import math

import torch
import torch.nn.functional as F

launches = 0
captured = 0

BACKEND = "FLASH_ATTENTION"          # torch.nn.attention.SDPBackend member
_NODE = "FlashAttention"             # in the name of its backward node


def attention(q, k, v):
    """q, k, v (B, H, N, D) -> (B, H, N, D)."""
    global launches, captured
    if q.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    if q.device.type != "cuda":
        return _plain(q, k, v)
    return _flash(q, k, v)


def _plain(q, k, v):
    scores = torch.matmul(q, k.transpose(-2, -1)).float() \
        / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


def _flash(q, k, v):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"attention on CUDA runs flash attention, which "
                         f"takes bf16 or float16 (the model's --amp 1); "
                         f"got {q.dtype}")
    with sdpa_kernel(getattr(SDPBackend, BACKEND)):
        out = F.scaled_dot_product_attention(q, k, v)
    if out.requires_grad and torch.backends.cudnn.deterministic:
        _pin_deterministic(out.grad_fn)
    return out


def _backward_node(node):
    """The flash backward's autograd node at or under `node` (the output's
    grad_fn, or a view's above it)."""
    seen, todo = set(), [node]
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        if _NODE in n.name():
            return n
        seen.add(n)
        todo.extend(f for f, _ in n.next_functions)
    raise RuntimeError(f"no {_NODE} backward node under {node.name()}")


def _pin_deterministic(node):
    node = _backward_node(node)
    saved = []

    def before(grad_outputs):
        saved.append((torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      torch.utils.deterministic.fill_uninitialized_memory))
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False

    def after(grad_inputs, grad_outputs):
        on, warn_only, fill = saved.pop()
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill

    node.register_prehook(before)
    node.register_hook(after)
