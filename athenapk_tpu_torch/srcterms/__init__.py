from .tabular_cooling import TabularCooling  # noqa: F401
