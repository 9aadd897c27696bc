"""Device resolution for the port's entry points.

The port runs on the CUDA card.  A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; a caller that names no device, or a
CUDA device, on a machine without CUDA gets an error, never a silent CPU
run.

The engine reads the device from the host only where it must decide
something there, and each such read goes through ``to_host``: one batched,
counted read (``host_reads``), so that tests can hold the engine to the JAX
package's count of blocking reads.  Host arrays go to the card through
``to_device``, which does not wait for the card's stream.
"""

from __future__ import annotations

import threading
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


_reads = [0]
_reads_lock = threading.Lock()


def host_reads() -> int:
    """The number of ``to_host`` calls so far in this process."""
    return _reads[0]


def to_host(*tensors) -> tuple:
    """One blocking read of ``tensors`` into numpy arrays, counted in
    ``host_reads``.  On the card every tensor is copied into pinned host
    memory on the current stream, which is then synchronised once; the
    arrays are copies, so the pinned blocks go back to their cache."""
    with _reads_lock:
        _reads[0] += 1
    if not any(t.is_cuda for t in tensors):
        return tuple(t.detach().numpy() for t in tensors)
    outs = []
    for t in tensors:
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t.detach(), non_blocking=True)
            t = h
        outs.append(t)
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return tuple(t.numpy().copy() for t in outs)


def to_device(array, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An array (numpy, a list, or a tensor) as a tensor on ``device``.  From
    the host to the card it goes through pinned memory without blocking: a
    copy from pageable memory waits for the card's stream, as a read does."""
    t = torch.as_tensor(array, dtype=dtype)
    if torch.device(device).type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
