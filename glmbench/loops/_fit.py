"""What the fit loops share: one call of ``fit_glm`` to convergence, and the
check of the window's fits against the reference's exact IRLS."""

import time

import numpy as np

from glmbench.reference.designs import relerr
from glmbench.reference.irls import irls


class FitLoop:
    """A closed loop of ``fit_glm`` calls with the configuration's settings."""

    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.fit_cfg = run.config["fit"]
        self.datasets = []

    def fit(self, design, y, weights, ps, l2: float) -> dict:
        """One fit from β = 0; failed where it used every step without
        meeting ``tol`` (``fit_glm`` then returns ``max_iter``) or where β is
        not finite."""
        f = self.fit_cfg
        t0 = time.perf_counter()
        beta, n_iter = self.run.tt.fit_glm(
            design, y, sample_weight=weights, family=self.cfg["family"],
            max_iter=f["max_iter"], tol=f["tol"], n_cg=f["n_cg"], l2=l2,
            inner_precision=f["inner_precision"], penalty_scale=ps)
        beta = beta.cpu().numpy().astype(np.float64)
        return {"kind": "fit", "latency_s": time.perf_counter() - t0, "n_iter": int(n_iter),
                "beta": beta, "l2": float(l2),
                "failed": bool(n_iter >= f["max_iter"] or not np.all(np.isfinite(beta)))}

    def free(self):
        """Drop the program's state before the reference runs."""
        for name in ("design", "y", "weights", "ps"):
            self.__dict__.pop(name, None)
        if self.run.device.type == "cuda":
            self.run.torch.cuda.empty_cache()

    def check(self, records, rng) -> list:
        """``beta_relerr``: the largest max|β - β_ref| / max|β_ref| over a
        sample of the window's fits drawn from the seed.  The reference
        encodes one dataset at a time."""
        count = min(int(self.run.mix["check_samples"]), len(records))
        picked = [records[i] for i in rng.choice(len(records), count, replace=False)]
        worst = 0.0
        for k in sorted({rec["dataset"] for rec in picked}):
            data = self.datasets[k]
            design = self.run.data.reference_design(data, self.cfg)
            ps = self.run.data.penalty_scale(self.cfg, design.shape[1])
            betas = {}
            for rec in (r for r in picked if r["dataset"] == k):
                if rec["l2"] not in betas:
                    betas[rec["l2"]], _ = irls(design, data["y"], data["weights"],
                                               self.cfg["family"], l2=rec["l2"], ps=ps)
                worst = max(worst, relerr(rec["beta"], betas[rec["l2"]]))
            del design
        return [("beta_relerr", worst, float(self.cfg["limits"]["beta_relerr"]))]
