"""95th percentile, over every call completed in the window, of the time
from the host's submission of the call to its outputs landing in pinned
host memory."""

import numpy as np

NAME = "rx_latency_p95_ms"
UNIT = "ms"


def read(window):
    lat = window.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
