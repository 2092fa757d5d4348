"""The galaxy-cluster application (reference ``src/pgen/cluster.cpp`` and
``src/pgen/cluster/``; counterpart of ``athenapk_tpu/pgen/cluster/``):
NFW/BCG/SMBH gravity, the ACCEPT entropy profile, the hydrostatic
initial state, AGN feedback and triggering, the magnetic tower, SN Ia and
stellar feedback, the cluster clips and the initial perturbations."""

from .entropy_profiles import ACCEPTEntropyProfile  # noqa: F401
from .gravity import ClusterGravity  # noqa: F401
from .hse import HydrostaticEquilibriumSphere  # noqa: F401
from .pgen import (estimate_timestep, estimate_timestep_factory,  # noqa: F401
                   estimate_timestep_smr, history_columns,
                   init_user_mesh_data, needs_ghosts_at_init,
                   problem_generator, problem_generator_smr,
                   problem_source_first_order,
                   problem_source_first_order_smr, problem_source_unsplit,
                   problem_source_unsplit_smr, register_defaults)
