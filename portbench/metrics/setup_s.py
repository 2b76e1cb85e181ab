"""Seconds from the process's start to the first timed request: imports,
weights, the program's build and the warm-up of every shape."""


def read(run):
    return run.get("setup_s")
