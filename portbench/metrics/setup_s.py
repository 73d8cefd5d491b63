"""setup_s: seconds from the start of the run to the start of the window: the corpus written, the
port imported, its kernels built (first run in a checkout) and its encoder made, one warm pass
over the cell's files."""


def read(ctx):
    return ctx.setup_s
