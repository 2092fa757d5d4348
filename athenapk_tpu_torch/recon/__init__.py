from .schemes import RECONSTRUCTIONS, reconstruct, nghost_for  # noqa: F401
