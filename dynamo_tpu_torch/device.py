"""The port's device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the first CUDA device and raises ``RuntimeError`` when
    CUDA is absent — nothing carries on quietly on the CPU.  Only an
    explicit ``"cpu"`` (what the CPU tests pass) selects the CPU, where the
    attention ops run their plain PyTorch versions instead of the kernels.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
