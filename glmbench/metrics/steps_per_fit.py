"""``steps_per_fit``: the Newton steps ``fit_glm`` reports (its ``n_iter``),
summed over the window's fits and divided by them."""


def read(ctx):
    fits = [r for r in ctx["records"] if r["kind"] == "fit"]
    return sum(r["n_iter"] for r in fits) / len(fits) if fits else None
