"""Problem generator registry.

The reference dispatches pgen callbacks by ``<job> problem_id``
(``src/main.cpp:60-123``); each problem is a module exposing
``problem_generator(pin, mesh, cfg, eos) -> cons`` (a numpy array) plus
optional hooks (``init_user_mesh_data``, ``history_columns``,
``user_work_after_loop``, ``register_boundary_conditions`` and its
refined-mesh form, ``check_refinement_block``, the source terms
``problem_source_unsplit``, ``problem_source_first_order`` and
``problem_source_strang`` with their ``_smr`` forms, and
``estimate_timestep_factory`` / ``estimate_timestep``, and on refined
meshes ``estimate_timestep_smr``; ``problem_generator_smr``, which builds
the whole refined state at once; ``needs_ghosts_at_init``, which keeps the
ghosts of a merged all-periodic mesh).  Every problem of the JAX package
is ported; decks with passive scalars (``advection``, ``cloud``,
``cluster``) run on the CPU and on the card's kernels alike.
"""

from importlib import import_module

_PGEN_MODULES = {
    "linear_wave": "athenapk_tpu_torch.pgen.linear_wave",
    "linear_wave_mhd": "athenapk_tpu_torch.pgen.linear_wave_mhd",
    "sod": "athenapk_tpu_torch.pgen.sod",
    "cpaw": "athenapk_tpu_torch.pgen.cpaw",
    "orszag_tang": "athenapk_tpu_torch.pgen.orszag_tang",
    "blast": "athenapk_tpu_torch.pgen.blast",
    "advection": "athenapk_tpu_torch.pgen.advection",
    "kh": "athenapk_tpu_torch.pgen.kh",
    "field_loop": "athenapk_tpu_torch.pgen.field_loop",
    "lw_implode": "athenapk_tpu_torch.pgen.lw_implode",
    "cloud": "athenapk_tpu_torch.pgen.cloud",
    "diffusion": "athenapk_tpu_torch.pgen.diffusion",
    "rand_blast": "athenapk_tpu_torch.pgen.rand_blast",
    "turbulence": "athenapk_tpu_torch.pgen.turbulence",
    "cluster": "athenapk_tpu_torch.pgen.cluster",
}


def get_pgen(problem_id: str):
    if problem_id not in _PGEN_MODULES:
        raise ValueError(f"unknown problem_id '{problem_id}'")
    return import_module(_PGEN_MODULES[problem_id])
