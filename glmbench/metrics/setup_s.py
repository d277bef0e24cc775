"""``setup_s``: seconds from the start of the run to the first timed
request: imports, loading the built kernels (building them on a
checkout's first run), making the data, the program's set-up and one warm
request of the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
