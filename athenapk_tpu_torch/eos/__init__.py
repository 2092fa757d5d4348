from .adiabatic import EOS, cons_to_prim, prim_to_cons  # noqa: F401
