"""host_syncs.<cell kind>: runtime calls in the traced window that block
the host until the card catches up (stream, device and event
synchronizes, synchronous copies), the harness's own left out, per unit
of work."""


def read(rec):
    if rec.view is None or not rec.units or not rec.view.launches:
        return None
    return rec.view.host_syncs() / rec.units
