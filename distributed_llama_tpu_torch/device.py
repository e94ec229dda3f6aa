"""Where the port's entry points and library functions put their tensors.

`resolve_device(None)` means the card, as the JAX package's functions land
on the default device, which is the accelerator. A CUDA device where none
is present raises: nothing falls back to the CPU on its own. A caller that
wants the CPU says so with `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`None` means the card. A CUDA device where none is present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
