"""The exit kernel's share of its roofline, in %: the least time one pass
over every lane's data needs (``counts.BatchWork.sync_bytes`` at the
card's HBM bandwidth; the bytes bound holds) over the device time of all
of a traced batch's exit-kernel launches."""
from perfbench import counts

KERNELS = ("exits_kernel",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    bound = spent = 0.0
    for ops, work in zip(run.trace.batches, run.traced_work):
        us = sum(op.us for op in ops if any(k in op.name for k in KERNELS))
        if us > 0:
            bound += counts.least_seconds(work.sync_bytes, 0, run.peaks)[0]
            spent += us / 1e6
    return 100.0 * bound / spent if spent > 0 else None
