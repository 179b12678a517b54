"""gnn_p95_ms: the 95th percentile (nearest rank) over every request of
the window of its time from issue until its answer is on the host, read
from CUDA events (the card's clock), in ms."""
import math


def read(rec):
    lat = sorted(rec.latencies_s or ())
    if not lat:
        return None
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
