"""``design_ms.refit``: mean host milliseconds of the ``design`` span,
``DeviceDesign.from_matrix`` ending in a synchronise, over the window."""


def read(ctx):
    spans = ctx["spans"].get("design")
    return 1e3 * sum(spans) / len(spans) if spans else None
