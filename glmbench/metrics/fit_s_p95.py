"""``fit_s_p95``: the 95th percentile of the latency of every fit of the
window, the failed ones with them."""

import numpy as np


def read(ctx):
    lat = [r["latency_s"] for r in ctx["records"] if r["kind"] == "fit"]
    return float(np.percentile(lat, 95)) if lat else None
