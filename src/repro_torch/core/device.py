"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "require_full_f32"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means the first CUDA card and
    raises when there is none, so nothing falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the card; pass "
                "device='cpu' to run its plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def require_full_f32() -> None:
    """Turn TF32 off for f32 matmuls and convolutions in this process.

    The attention einsums must keep full f32, as the reference does; TF32
    keeps about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
