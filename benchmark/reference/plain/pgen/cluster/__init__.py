"""A frozen copy of the port's galaxy-cluster application
(``athenapk_tpu_torch/pgen/cluster/``, reference ``src/pgen/cluster.cpp``
and ``src/pgen/cluster/``) on one uniform mesh, for the benchmark's plain
reference: NFW/BCG/SMBH gravity, the ACCEPT entropy profile, the
hydrostatic initial state, AGN feedback and triggering, the magnetic
tower, SN Ia and stellar feedback, the cluster clips and the initial
perturbations.  It imports nothing of the program."""
