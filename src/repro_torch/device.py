"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``cuda``, and a ``cuda`` request on a machine without a usable
GPU raises.  There is no silent CPU fallback — a run that believes it
measured the card must never have measured the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is requested but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
