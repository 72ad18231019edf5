"""Kernel launches a batch of the window:
``ParallelDecoder.launch_stats()``'s launches by wrapper plus its CUDA
graph replays, exact with one decode at a time."""


def read(run):
    return sum(run.launches) / len(run.launches) if run.launches else None
