"""Set-up: the process's start to the opening of the window (host clock)."""


def read(run):
    return run.setup_s
