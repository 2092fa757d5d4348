"""Zone-cycles per second: the mesh's cells times the window's cycles over
the host-clock seconds of the whole window (one ``Simulation.run`` call,
which ends in a synchronise)."""


def read(run):
    return run["zone_cycles_per_s"]
