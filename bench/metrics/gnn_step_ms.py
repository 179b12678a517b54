"""gnn_step_ms: the window's seconds over the units of GNN work it
completed (a full-graph inference request, or a training step), in ms."""


def read(rec):
    if not rec.units:
        return None
    return rec.window_s / rec.units * 1e3
