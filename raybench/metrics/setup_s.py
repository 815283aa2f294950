"""Process start to the first timed unit: imports, CUDA start-up, the
scene build, kernel library load (and, in a fresh checkout, its build)
and the warm-up, on the host clock."""


def read(ctx):
    return ctx.setup_s
