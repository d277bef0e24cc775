"""The ``refit`` loop: the user's whole call, from a frame to a fitted model.

Each request builds the design from one of the mix's ``datasets`` frames
(``from_formula``), turns it into the operator the solver drives
(``DeviceDesign.from_matrix``) and fits it to convergence with the
configuration's ``l2``: what ``GeneralizedLinearRegressor(formula=...).fit``
does.  The frames are made at set-up and cycled; nothing of one request is
kept for the next.
"""

import time

from glmbench.loops._fit import FitLoop


class Loop(FitLoop):
    def setup(self):
        from tabmat_torch.parallel.design import DeviceDesign

        run = self.run
        self.DeviceDesign = DeviceDesign
        self.datasets = run.data.make(self.cfg, run.seed, int(run.mix["datasets"]))

    def request(self, i: int) -> dict:
        run = self.run
        k = i % len(self.datasets)
        data = self.datasets[k]
        t0 = time.perf_counter()
        with run.span("formula"):
            X = run.data.to_program(run.tt, data, self.cfg, run.dtype, run.device)
        with run.span("design"):
            design = self.DeviceDesign.from_matrix(X)
            run.sync()
        ps = run.data.penalty_scale(self.cfg, X.shape[1])
        with run.span("fit"):
            rec = self.fit(design, data["y"].astype(run.dtype, copy=False),
                           data["weights"].astype(run.dtype, copy=False), ps,
                           self.fit_cfg["l2"])
        rec.update(latency_s=time.perf_counter() - t0, dataset=k)
        return rec
