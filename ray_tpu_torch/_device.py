"""Where the port's entry points run.

Every entry point takes ``device=None``, which means the CUDA card. The
CPU is used only when the caller asks for it (``device="cpu"``, as the
tests do): a missing card is an error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise RuntimeError when that card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
