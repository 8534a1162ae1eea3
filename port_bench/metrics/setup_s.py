"""setup_s: from the process's start to the end of the warm-up: imports,
the kernels' build on a checkout's first run, the seeded data, the
program's objects and one pass over every shape the window uses."""


def read(run):
    return run.setup_s
