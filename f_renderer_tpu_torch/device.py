"""Where the port's tensors live.

Every public constructor of the port defaults to ``device="cuda"`` and
resolves it here, so without a card it raises: nothing falls back to the
CPU. A caller that wants the CPU (the tests, the plain versions of the
kernels) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@functools.lru_cache(maxsize=None)
def constant(value, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A device tensor of ``value`` (a number or a tuple of numbers), made
    once per ``(value, device, dtype)``; callers never write to it.

    A frame reads its constants from here, not from ``torch.tensor`` of
    host data: that copy from pageable memory cannot be recorded into a
    CUDA graph, and a captured graph reads the tensor by its address, so the
    cache keeps every tensor alive (it holds a few small ones). A 0-d or
    small tensor and not a Python number, because CUDA divides by a Python
    number through its reciprocal (``math.transforms.true_div``).
    """
    return torch.tensor(value, dtype=dtype, device=device)


_frame = threading.local()


@contextlib.contextmanager
def graph_frame():
    """Run the frame inside as a captured frame runs (its capture and its
    warm-up): no host sync. Where the eager frame asks the host (has any
    face clipped?), a capture on the card records the choice as a
    conditional node (:func:`if_node`); outside a capture (the warm-up
    frame, the CPU) the frame computes both answers and chooses on the
    device."""
    before = getattr(_frame, "graph", False)
    _frame.graph = True
    try:
        yield
    finally:
        _frame.graph = before


def in_graph_frame() -> bool:
    """Whether the caller runs inside :func:`graph_frame`."""
    return getattr(_frame, "graph", False)


def capturing(device: torch.device) -> bool:
    """Whether work on ``device`` is being captured into a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def node_memory():
    """Collect the memory pools of the conditional nodes (:func:`if_node`)
    captured in the block → a list the caller keeps as long as its graph:
    a replay writes into that memory."""
    before = getattr(_frame, "pools", None)
    _frame.pools = kept = []
    try:
        yield kept
    finally:
        _frame.pools = before


def if_node(pred, fn, *args) -> None:
    """``fn(*args)`` captured as a conditional node of the CUDA graph being
    captured (``lax.cond`` inside a compiled program): each replay runs it
    only where ``pred`` holds on the card, and skips it otherwise: a 0-d
    bool tensor, or a ``kernels.Condition`` that a kernel captured before
    the node sets (the triangle set-up's launch 1). ``fn`` writes its results into tensors made before the node
    (what it returns is dropped); its memory is kept by the enclosing
    :func:`node_memory`. A capture that cannot hold the node raises."""
    from f_renderer_tpu_torch import kernels

    pools = getattr(_frame, "pools", None)
    if pools is None:
        raise RuntimeError("a conditional node's memory must live as long as its graph: capture inside "
                           "device.node_memory()")
    pools.append(kernels.if_node(pred, fn, *args))
