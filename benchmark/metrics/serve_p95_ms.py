"""The 95th percentile of the latency of every request of the window, from
when it was due to when predict returned its graphs (host clock)."""

import numpy as np


def read(r):
    return float(np.percentile(r.latency_ms, 95)) if r.latency_ms else None
