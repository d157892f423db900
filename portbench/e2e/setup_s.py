"""Seconds from the process's start to the window's start: imports, the
frames made, the checkpoint written and loaded, the kernel library
loaded (built on a checkout's first run), the warm-up.  Making the
weights, the benchmark's own reference work, is left out."""


def read(run):
    return run.setup_s
