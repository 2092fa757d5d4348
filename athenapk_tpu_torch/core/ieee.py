"""A correctly rounded square root, and a power that rounds alike in every
call, for the plain (PyTorch) versions.

On a CPU tensor PyTorch takes ``torch.sqrt`` from MKL's vector math
(``vdSqrt`` / ``vsSqrt``, ``ATen/cpu/vml.h``), which is not correctly
rounded (about 1 % of f64 and f32 values land one ulp off) and which
``parallel_for`` cuts into chunks of 2048 elements across threads: a chunk
can come back with other roundings than the same chunk in another call,
so two calls of one function on one input could differ (seen on the first
call of a process under CPU load, in the chunks a second thread took).
numpy's square root is IEEE's, as XLA's on the CPU and CUDA's are, so a
CPU tensor takes numpy's; on any other device ``torch.sqrt`` is IEEE's
already.  ``power`` takes numpy's on a CPU tensor for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x):
    """Square root of a tensor, correctly rounded on every device."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    out = torch.empty_like(x)
    with np.errstate(invalid="ignore"):
        np.sqrt(x.numpy(), out=out.numpy())
    return out


def power(a, b):
    """``a ** b``: a and b tensors, or one of them a Python float."""
    ref = a if torch.is_tensor(a) else b
    if ref.device.type != "cpu":
        return torch.pow(a, b)
    na = a.numpy() if torch.is_tensor(a) else a
    nb = b.numpy() if torch.is_tensor(b) else b
    with np.errstate(all="ignore"):
        out = np.power(na, nb)
    return torch.from_numpy(np.asarray(out, dtype=ref.numpy().dtype))
