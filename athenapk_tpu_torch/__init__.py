"""athenapk_tpu_torch: the PyTorch + CUDA port of athenapk_tpu.

A second package beside the JAX one, mirroring it module by module
(``core``, ``config``, ``eos``, ``recon``, ``riemann``, ``solver``,
``pgen``, ``outputs``, ``driver``).  Plain tensor code is PyTorch; the
fused -div(F) sweep (reconstruction + Riemann solve + flux divergence) is
a CUDA kernel written for Hopper (``csrc/negdiv_sweep.cu``), with a plain
PyTorch twin that the CPU path and the tests use.

State is ``[nblocks, nvar, NZ, NY, NX]`` as in the JAX package; its dtype
is chosen per simulation (``hydro/precision``), nothing global is flipped.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .config.parameter_input import ParameterInput  # noqa: E402,F401
