"""Options priced in the window over the window's whole time: every call
started in the window counts, and the window ends when its last call
returns its results to the host."""


def read(run):
    return run.work_done / run.window_s
