"""Seconds from the start of the process to the first timed call: imports,
the card's start, building or loading the kernels, making the inputs and
running every book of the pool once."""


def read(run):
    return run.setup_s
