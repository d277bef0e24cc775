"""The ``std_fit`` loop: glum's fit with an intercept on one standardized
design, refitted at one alpha.

The design (the configuration's ``StandardizedMatrix`` of ``[1 | X]``), its
response and weights are built on the card once at set-up.  Each request is
one ``fit_glm`` on that ``StandardizedMatrix`` from β = 0 at the
configuration's ``l2``: ``DeviceDesign.from_matrix``, then the Newton steps
on the route the design's ``supports_sandwich`` picks.  A request records
the launches of each ``spmv`` instantiation it made (the wrapper's counts,
``tabmat_torch.ops.spmv_kernel.launches``), which ``spmv_roofline.std_fit``
reads.

The check solves the reference's Newton steps on the card
(``reference/standardized_intercept.py``).
"""

import time

import numpy as np

from glmbench.loops._fit import FitLoop
from glmbench.reference import standardized_intercept
from glmbench.reference.designs import relerr


class Loop(FitLoop):
    def setup(self):
        run = self.run
        torch = run.torch
        from tabmat_torch.ops import spmv_kernel

        self.launches = spmv_kernel.launches
        self.datasets = run.data.make(self.cfg, run.seed, 1)
        data = self.datasets[0]
        tdtype = torch.float32 if run.dtype == np.float32 else torch.float64

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=run.dtype), dtype=tdtype,
                                   device=run.device)

        self.X = run.data.to_program(run.tt, data, self.cfg, run.dtype, run.device)
        self.y, self.weights = t(data["y"]), t(data["weights"])
        self.ps = t(run.data.penalty_scale(self.cfg, self.X.shape[1]))

    def request(self, i: int) -> dict:
        before = dict(self.launches)
        t0 = time.perf_counter()
        with self.run.span("fit"):
            rec = self.fit(self.X, self.y, self.weights, self.ps, self.fit_cfg["l2"])
        rec.update(latency_s=time.perf_counter() - t0, dataset=0,
                   spmv_launches={name: n - before.get(name, 0)
                                  for name, n in self.launches.items()})
        return rec

    def free(self):
        self.__dict__.pop("X", None)
        super().free()

    def check(self, records, rng) -> list:
        """``beta_relerr``: the largest max|β - β_ref| / max|β_ref| over a
        sample of the window's fits drawn from the seed; infinite where a
        sampled β is not finite."""
        count = min(int(self.run.mix["check_samples"]), len(records))
        picked = [records[i] for i in rng.choice(len(records), count, replace=False)]
        data = self.datasets[0]
        design = self.run.data.reference_design(data, self.cfg)
        ps = self.run.data.penalty_scale(self.cfg, design.shape[1])
        beta_ref, _ = standardized_intercept.irls(
            design, data["y"], data["weights"], self.cfg["family"], l2=self.fit_cfg["l2"], ps=ps)
        del design
        worst = 0.0
        for rec in picked:
            error = relerr(rec["beta"], beta_ref)
            worst = max(worst, error if np.isfinite(error) else float("inf"))
        return [("beta_relerr", worst, float(self.cfg["limits"]["beta_relerr"]))]
