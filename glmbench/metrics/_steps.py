"""The Newton steps of the fits that ran inside the traced window."""


def traced_steps(ctx) -> int:
    return sum(r["n_iter"] for r in ctx["records"] if r["kind"] == "fit" and r["traced"])
