"""``fit_s``: the window's seconds over the fits that converged in it.
The window runs until the fit in progress at its end is done."""


def read(ctx):
    fits = [r for r in ctx["records"] if r["kind"] == "fit"]
    done = sum(1 for r in fits if not r["failed"])
    if not fits or done == 0:
        return None
    return ctx["window_s"] / done
