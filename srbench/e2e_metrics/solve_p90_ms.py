"""The 90th percentile of per-call latency, from the call's start to its
numpy results, over all calls of the window, ms."""

import numpy as np


def read(window, cell):
    return float(np.percentile(window.latencies_s, 90)) * 1e3
