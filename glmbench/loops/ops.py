"""The ``ops`` loop: glum's IRLS call pattern on the matrix API.

Each request is ``X.matvec(v)``, ``X.transpose_matvec(r)`` and
``X.sandwich(d)`` on all rows and columns of the configuration's matrix,
then a synchronise: the caller reads the results.  ``v``, ``r`` and ``d``
come from a pool of the mix's ``pool`` vectors each, made on the device
from the seed and cycled; ``d`` is positive, as IRLS weights are.  A
sample of the window's results, drawn from the seed as the window runs
(a reservoir), is checked against the reference afterwards.
"""

import time

import numpy as np

from glmbench.reference.designs import relerr


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.kept = []
        self.seen = 0

    def setup(self):
        run = self.run
        torch = run.torch
        self.data = run.data.make(self.cfg, run.seed, 1)[0]
        self.X = run.data.to_program(run.tt, self.data, self.cfg, run.dtype, run.device)
        n, k = self.X.shape
        pool = int(run.mix["pool"])
        tdtype = torch.float32 if run.dtype == np.float32 else torch.float64
        gen = torch.Generator(device=run.device)
        gen.manual_seed(run.seed)
        self.v = torch.randn((pool, k), generator=gen, dtype=tdtype, device=run.device)
        self.r = torch.randn((pool, n), generator=gen, dtype=tdtype, device=run.device)
        self.d = torch.rand((pool, n), generator=gen, dtype=tdtype, device=run.device) + 0.05
        self.samples = int(run.mix["check_samples"])
        self.rng = np.random.default_rng([run.seed, 11])

    def request(self, i: int) -> dict:
        run, X = self.run, self.X
        j = i % self.v.shape[0]
        t0 = time.perf_counter()
        with run.span("matvec"):
            a = X.matvec(self.v[j])
        with run.span("tmv"):
            b = X.transpose_matvec(self.r[j])
        with run.span("sandwich"):
            S = X.sandwich(self.d[j])
        run.sync()
        latency = time.perf_counter() - t0
        if i >= 0:
            self._keep((j, a, b, S))
        return {"kind": "ops", "latency_s": latency, "failed": False, "pool_index": j}

    def _keep(self, item):
        """Reservoir sampling: each request of the window is kept with the
        same chance, drawn from the seed."""
        self.seen += 1
        if len(self.kept) < self.samples:
            self.kept.append(item)
            return
        slot = int(self.rng.integers(0, self.seen))
        if slot < self.samples:
            self.kept[slot] = item

    def free(self):
        """Copy the kept results and their inputs to the host; drop the rest."""
        def host(t):
            return t.cpu().numpy().astype(np.float64)

        self.kept = [(host(self.v[j]), host(self.r[j]), host(self.d[j]), host(a), host(b),
                      host(S)) for j, a, b, S in self.kept]
        del self.X, self.v, self.r, self.d
        if self.run.device.type == "cuda":
            self.run.torch.cuda.empty_cache()

    def check(self, records, rng) -> list:
        """The largest relative error of each op over the kept results."""
        ref = self.run.data.reference_design(self.data, self.cfg)
        worst = {"matvec_relerr": 0.0, "tmv_relerr": 0.0, "sandwich_relerr": 0.0}
        for v, r, d, a, b, S in self.kept:
            worst["matvec_relerr"] = max(worst["matvec_relerr"], relerr(a, ref.matvec(v)))
            worst["tmv_relerr"] = max(worst["tmv_relerr"], relerr(b, ref.tmv(r)))
            worst["sandwich_relerr"] = max(worst["sandwich_relerr"], relerr(S, ref.hessian(d)))
        if not self.kept:
            return []
        limits = self.cfg["limits"]
        return [(name, value, float(limits[name])) for name, value in worst.items()]
