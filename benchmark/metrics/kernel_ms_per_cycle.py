"""Device milliseconds per cycle of the port's own kernels (``csrc/``:
``negdiv_sweep``, ``negdiv_scalars``, ``fused_stage``, ``stage_scalars``),
found by name in the trace."""


def read(run):
    tr = run.get("trace")
    ops = tr.csrc_ops() if tr is not None else []
    return tr.ms_per_cycle(ops) if ops else None
