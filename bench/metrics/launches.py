"""launches.<cell kind>: kernels the card ran in the traced window, per
unit of work (request or step)."""


def read(rec):
    if rec.view is None or not rec.units:
        return None
    kernels = rec.view.kernels()
    if not kernels:
        return None
    return len(kernels) / rec.units
