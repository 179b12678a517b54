"""mfu.<cell kind>: the model FLOPs of a unit of work (a fixed formula of
the configuration's shapes, ``bench/roofline.py``) over the seconds a unit
took in the traced run's untraced units just before its trace, times the
card's peak for the configuration's dtype, in %."""


def read(rec):
    if not rec.unit_s or not rec.flops_per_unit:
        return None
    return 100.0 * rec.flops_per_unit / rec.unit_s / rec.peak_flops
