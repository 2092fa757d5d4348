from .diffusion import DiffusionConfig, calc_diff_fluxes, estimate_diff_dt  # noqa: F401
