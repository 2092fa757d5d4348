"""Multi-rank runs over ``torch.distributed``: the rank mesh and state
placement (``mesh_sharding``), the uniform mesh's halo exchange and sharded
step (``halo``), and a dry run over N processes (``dryrun``)."""
