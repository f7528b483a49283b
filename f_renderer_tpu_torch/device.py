"""Where the port's tensors live.

Every public constructor of the port defaults to ``device="cuda"`` and
resolves it here, so without a card it raises: nothing falls back to the
CPU. A caller that wants the CPU (the tests, the plain versions of the
kernels) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
