"""``formula_ms.refit``: mean host milliseconds of the ``formula`` span,
the benchmark's call of ``from_formula`` on a frame, over the window."""


def read(ctx):
    spans = ctx["spans"].get("formula")
    return 1e3 * sum(spans) / len(spans) if spans else None
