"""Kernel launch counts that see CUDA graphs.

Each wrapper counts its launches in `.launches` so a run can show that its
path went through the kernel. A launch made while the calling thread
captures a CUDA graph runs nothing: the graph holds it, and it runs once
each time the graph is replayed. So a wrapper calls `count` where it
launches its kernel, and the code that captures and replays a graph
brackets the capture with `capturing()` and calls `replayed` after each
replay: a capture adds nothing, each replay adds the launches the graph
holds, and a warm-up run before a capture counts as what it is, launches.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from repro_torch.analysis.races import named_lock

_lock = named_lock("kernel.launches")
_local = threading.local()


def count(wrapper, kernel: str | None = None) -> None:
    """One launch of `wrapper`'s kernel on the current CUDA stream (of its
    kernel `kernel`, for a wrapper that also counts by kernel in
    `.launches_by_kernel`): counted now, or, while this thread captures a
    graph, held by the graph."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        held = getattr(_local, "held", None)
        if held is None:
            raise RuntimeError(
                f"{wrapper.__name__}: launched inside a CUDA graph capture "
                "without launches.capturing(): its replays would go uncounted"
            )
        held[wrapper, kernel] = held.get((wrapper, kernel), 0) + 1
        return
    replayed({(wrapper, kernel): 1})


@contextmanager
def capturing():
    """Collect the launches that a graph captured on this thread holds:
    yields the dict {(wrapper, kernel): launches}, filled as the capture
    runs."""
    prev = getattr(_local, "held", None)
    held: dict = {}
    _local.held = held
    try:
        yield held
    finally:
        _local.held = prev


def replayed(held: dict) -> None:
    """One replay of a graph that holds `held` launches: count them."""
    with _lock:
        for (wrapper, kernel), n in held.items():
            wrapper.launches += n
            if kernel is not None:
                wrapper.launches_by_kernel[kernel] += n
