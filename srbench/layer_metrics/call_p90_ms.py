"""The 90th percentile of per-call latency, from the call's start to its
numpy results, over the window's calls outside the traced stretch, ms:
``solve_p90_ms`` on the host clock, in a cell whose runs spread too widely
for that metric to hold a bound there."""

import numpy as np


def read(window, cell):
    lat = [v for i, v in enumerate(window.latencies_s)
           if i not in window.traced_calls]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
