"""``ops_ms_p95``: the 95th percentile of the latency of every request of
the window, in milliseconds."""

import numpy as np


def read(ctx):
    lat = [r["latency_s"] for r in ctx["records"] if r["kind"] == "ops"]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
