"""``DecodeOutput.sync_rounds``, the mean over every batch of the window."""


def read(run):
    return sum(run.rounds) / len(run.rounds) if run.rounds else None
