"""device_idle.<cell kind>: the share of a unit's untraced seconds in
which no operation ran on the card, 1 - (the traced window's union of
device events over its units) / (a unit's seconds untraced, just before
the trace), in %. The traced window's own length is not the denominator:
the profiler's host cost stretches it, and the card waits on the host."""


def read(rec):
    if rec.view is None or not rec.units or not rec.unit_s:
        return None
    return 100.0 * (1.0 - rec.view.busy_s() / rec.units / rec.unit_s)
