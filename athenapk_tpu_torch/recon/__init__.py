from .schemes import (RECONSTRUCTIONS, nghost_for,  # noqa: F401
                      positivity_mask, reconstruct)
