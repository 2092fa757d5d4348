"""Problem generator registry.

The reference dispatches pgen callbacks by ``<job> problem_id``
(``src/main.cpp:60-123``); each problem is a module exposing
``problem_generator(pin, mesh, cfg, eos) -> cons`` (a numpy array) plus
optional hooks (``init_user_mesh_data``, ``history_columns``,
``user_work_after_loop``).  Only the ported problems are listed; the others
of the JAX package raise ``NotImplementedError``.
"""

from importlib import import_module

_PGEN_MODULES = {
    "linear_wave": "athenapk_tpu_torch.pgen.linear_wave",
    "linear_wave_mhd": "athenapk_tpu_torch.pgen.linear_wave_mhd",
}

# problem generators of the JAX package that this port does not have yet
_NOT_PORTED = ("sod", "cpaw", "orszag_tang", "blast", "advection", "kh",
               "field_loop", "lw_implode", "diffusion", "rand_blast",
               "turbulence", "cloud", "cluster")


def get_pgen(problem_id: str):
    if problem_id in _NOT_PORTED:
        raise NotImplementedError(
            f"problem_id '{problem_id}' is not ported to athenapk_tpu_torch "
            f"yet (ported: {', '.join(_PGEN_MODULES)})")
    if problem_id not in _PGEN_MODULES:
        raise ValueError(f"unknown problem_id '{problem_id}'")
    return import_module(_PGEN_MODULES[problem_id])
