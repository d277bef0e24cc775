"""The ``path`` loop: a regularisation path on one design.

The design is built once at set-up (the configuration's constructors, then
``DeviceDesign.from_matrix``), with the response and weights on the card.
Each request is one ``fit_glm`` from β = 0 at the next ``l2`` of the
configuration's ``l2_grid``, cycled, as glum's users fit a path to choose a
penalty.
"""

import time

import numpy as np

from glmbench.loops._fit import FitLoop


class Loop(FitLoop):
    def setup(self):
        run = self.run
        torch = run.torch
        from tabmat_torch.parallel.design import DeviceDesign

        self.datasets = run.data.make(self.cfg, run.seed, 1)
        data = self.datasets[0]
        X = run.data.to_program(run.tt, data, self.cfg, run.dtype, run.device)
        self.design = DeviceDesign.from_matrix(X)
        tdtype = torch.float32 if run.dtype == np.float32 else torch.float64

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=run.dtype), dtype=tdtype,
                                   device=run.device)

        self.y, self.weights = t(data["y"]), t(data["weights"])
        self.ps = t(run.data.penalty_scale(self.cfg, X.shape[1]))
        self.grid = [float(v) for v in self.fit_cfg["l2_grid"]]

    def request(self, i: int) -> dict:
        l2 = self.grid[i % len(self.grid)]
        t0 = time.perf_counter()
        with self.run.span("fit"):
            rec = self.fit(self.design, self.y, self.weights, self.ps, l2)
        rec.update(latency_s=time.perf_counter() - t0, dataset=0)
        return rec
