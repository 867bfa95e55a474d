"""The device rule of the port's entry points: the GPU unless the caller
asks for another device, and no silent fallback to the CPU."""
from __future__ import annotations

import torch

from repro_torch.analysis.races import named_rlock

#: Held while a CUDA graph is warmed up and captured, by every capture of
#: the port (`apps.tsunami._replay`, `uq.fused`). Entering
#: `torch.cuda.graph` synchronizes the device and empties the allocator's
#: cache, which breaks a capture that another thread of the process has
#: under way, whichever model or block it belongs to (on an H100, two
#: handler threads of one server capturing gradient waves at once failed
#: with cudaErrorStreamCaptureUnsupported and ...Invalidated). Replays do
#: not take it: captured graphs still run side by side. Reentrant, so a
#: capture started under it fails as CUDA fails it and never hangs.
CAPTURE_LOCK = named_rlock("cuda.capture")


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. A CUDA device without a usable GPU raises: the
    entry points never fall back to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device
