"""The device and dtype of a run, as every entry point resolves them."""

from __future__ import annotations

import torch

# hydro/precision
DTYPES = {"double": torch.float64, "single": torch.float32}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; refuses CUDA where there is none
    rather than quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU "
                           "explicitly (device='cpu', or --device cpu)")
    return dev
