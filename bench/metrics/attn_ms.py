"""attn_ms.<cell kind>: the device time of GAT's attention a unit of work,
in ms.

The program opens the span ``gat.attention`` in every GAT layer around
the two score products, the scores' per-edge rows, the LeakyReLU and the
segment softmax (``repro_torch/models/gnn.py`` ``GATLayer``), never
around the layer's transform, its skip or its weighted sums (those are
``mp.aggregate``'s); under the profiler the span is a ``user_annotation``
range of that name. The reading sums the device time of the kernels
launched inside the traced window's ``gat.attention`` ranges, each kernel
tied to its launch by the profiler's correlation id and the launch to the
range open on its thread, over the window's units. A window with no such
range (a model without attention, or a program without the span) reads
nothing.
"""

RANGE = "gat.attention"


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
