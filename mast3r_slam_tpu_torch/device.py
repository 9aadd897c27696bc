"""Device resolution for the port's entry points.

The port runs on the CUDA card.  A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; a caller that names no device, or a
CUDA device, on a machine without CUDA gets an error, never a silent CPU
run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card; else ``torch.device(device)``.  A CUDA
    device always carries its card's index (``"cuda"`` is the current card),
    so that it compares equal to its tensors' ``.device``.  A CUDA device
    raises where there is no card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return indexed(dev)


def indexed(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its card's index: ``"cuda"`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def record_on(stream, device: torch.device, tensors) -> None:
    """``record_stream(stream)`` for each tensor of ``tensors`` that lies on
    ``device`` (a resolved device), so the caching allocator does not hand
    its memory to another stream while ``stream`` may still read it.  A
    tensor from another card reaches ``stream``'s work only by a copy."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device == device:
            t.record_stream(stream)
