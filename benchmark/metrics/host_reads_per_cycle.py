"""Reads of a device tensor to the host per cycle of the traced stretch
(``item``, ``tolist``, ``cpu``, ``numpy``, ``float``, ``int``, ``bool``,
counted at the tensor methods): each stalls the host on the device."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr.host_reads is None:
        return None
    return tr.host_reads / tr.cycles
