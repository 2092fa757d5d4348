"""Share of its roofline that the sweep kernel (``csrc/negdiv_sweep.cu``,
the fluid rows) reaches over the traced stretch, in %: its launches' least
times (bytes over 3.35 TB/s or operations over the dtype's rate, the
larger; ``harness/roofline.py``) over their measured times."""

from benchmark.harness.roofline import share


def read(run):
    tr = run.get("trace")
    return share(tr, "negdiv_sweep") if tr is not None else None
