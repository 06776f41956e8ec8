"""Device selection for the port's entry points.

Every entry point (``BoxPSEngine``, ``SparseTrainer``, the kernel
wrappers' callers) runs on the card unless the caller names the CPU.  A
missing card is an error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available — pass device='cpu' to run on the CPU")
    return dev
