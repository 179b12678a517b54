"""mp_ms.<cell kind>: the device time of message passing a unit of work,
in ms.

The program opens the span ``mp.aggregate`` around every gather, fused
and segment-op call of its message passing (``repro_torch/core/mp.py``),
never around a layer's dense product; under the profiler the span is a
``user_annotation`` range of that name. The reading sums the device time
of the kernels launched inside the traced window's ``mp.aggregate``
ranges, each kernel tied to its launch by the profiler's correlation id
and the launch to the range open on its thread, over the window's units.
Whichever kernel a change puts inside the layer, the reading holds it. A
window with no such range (a program without the span) reads nothing.
"""

RANGE = "mp.aggregate"


def read(rec):
    view = rec.view
    if view is None or not rec.units:
        return None
    ranges = [e for e in view.host_ops
              if e.name == RANGE and e.cat == "user_annotation"]
    if not ranges:
        return None
    tied = view.kernels_launched_in(ranges)
    return sum(k.dur for ks in tied.values() for k in ks) / rec.units * 1e3
