"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU;
without a CUDA device they raise rather than carry on quietly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "describe_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, checked, with the fp32 numerics set.

    Raises ``RuntimeError`` for a CUDA device when none is available."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available. Its entry points run "
            "on the GPU by default; pass device='cpu' (on the command line: "
            "--device cpu) to run on the CPU")
    # fp32 throughout, as the reference computes: TF32 (about three decimal
    # digits) off for matrix products and for cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def describe_device(dev: torch.device) -> str:
    """``'cpu'`` or ``'cuda:<i> (<device name>)'``, for results and logs."""
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"
