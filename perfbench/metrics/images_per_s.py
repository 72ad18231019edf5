"""Images whose RGB the window finished, over the window's seconds."""


def read(run):
    return run.images / run.window_s if run.window_s > 0 else None
