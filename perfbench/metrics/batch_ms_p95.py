"""The 95th percentile over every batch of the window of the time from the
call into ``decode`` to its RGB being ready (host clock, ending in a
synchronise), in ms."""
import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.batch_s, 95)) if run.batch_s else None
