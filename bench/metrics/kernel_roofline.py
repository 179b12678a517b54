"""kernel_roofline.<cell kind>: the port's custom ops in the traced window
against their roofline, in %.

The numerator is the least time the work of the window's custom-op calls
needs (``bench/roofline.py``): one unit's calls, as the shapes' profiler
recorded their arguments, times the window's units (a unit runs the same
calls at the same shapes; a window whose count of calls differs reads
nothing). The denominator sums the device time of the kernels launched
inside the window's calls of ``repro_torch::*`` ops. Attribution is by op,
each kernel tied to its launch by the profiler's correlation id and the
launch to the op open on its thread, so a change of kernel inside an op
reckons the same work. A window in which a kernel of the port (a
``__global__`` function of ``src/repro_torch/kernels/csrc``) is not tied
to a call of an op reads nothing: the attribution is broken, and another
denominator would measure something else.
"""
from bench import roofline
from bench import trace as tr


def read(rec):
    view = rec.view
    if view is None or not rec.op_calls:
        return None
    calls = view.custom_ops()
    if len(calls) != len(rec.op_calls) * rec.units:
        return None
    least = rec.units * sum(roofline.op_least_s(name, args)
                            for name, args in rec.op_calls)
    tied = [k for ks in view.kernels_launched_in(calls).values() for k in ks]
    is_port = tr.port_kernel_matcher(tr.port_kernel_names(rec.csrc))
    if any(is_port(k.name) for k in set(view.kernels()) - set(tied)):
        return None
    spent = sum(k.dur for k in tied)
    if spent <= 0:
        return None
    return 100.0 * least / spent
