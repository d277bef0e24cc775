"""``ops_ms``: the window's milliseconds over the matrix-API requests
completed in it (each a matvec, a transpose-matvec and a sandwich, read back)."""


def read(ctx):
    n = sum(1 for r in ctx["records"] if r["kind"] == "ops" and not r["failed"])
    return 1e3 * ctx["window_s"] / n if n else None
