"""Process start to the window's start: imports, the card, the kernels'
build where it is not cached, the frames, the ring's plans and warm-up."""


def read(run):
    return run.setup_s
