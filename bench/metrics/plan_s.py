"""plan_s.<cell kind>: the seconds of the program's newest plan build, on
the host clock: the newest root span ``plan.build`` in the ring of the
program's telemetry (``repro_torch.obs``), whose stages are the spans
``plan.*`` under it (``repro_torch/core/plan.py``). The module is read
where the program loaded it (``sys.modules``), never imported here: a
run whose program has not loaded it, or built no plan under that span,
reads nothing.
"""
import sys

SPAN = "plan.build"


def read(rec):
    obs = sys.modules.get("repro_torch.obs")
    if obs is None:
        return None
    roots = obs.spans(SPAN)
    return roots[-1].dur_s if roots else None
