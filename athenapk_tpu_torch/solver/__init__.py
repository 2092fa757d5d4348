from .hydro_pkg import HydroConfig, HydroPackage  # noqa: F401
