"""Share of the traced stretch in which no device operation ran, in %:
100 (1 - union of the device operations' intervals / the stretch)."""


def read(run):
    tr = run.get("trace")
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
