"""Random draws for the model families' init functions."""

from __future__ import annotations

from typing import Sequence

import torch


def normal(shape: Sequence[int], std: float, dtype: torch.dtype,
           generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """A standard normal draw of ``shape`` times ``std``, in ``dtype``.

    Drawn in f32 on the generator's device, scaled, then cast: a CPU
    generator gives the same weights on every device."""
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device)
    return (x * std).to(device=device, dtype=dtype)
