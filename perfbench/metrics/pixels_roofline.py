"""The pixel stage's share of its roofline, in %: the least time of
``counts.BatchWork.pixel_bytes`` and ``pixel_flops`` on the card over
the device time of a traced batch's pixel stage, every device operation
from its first kernel (the fused pixel kernel, or the IDCT kernel with
the plane assembly and the color kernel after it) to the batch's end."""
from perfbench import counts, tracing

FIRST = ("pixels_kernel", "idct_kernel")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    bound = spent = 0.0
    for ops, work in zip(run.trace.batches, run.traced_work):
        a = tracing.first_index(ops, FIRST)
        if a < 0:
            continue
        bound += counts.least_seconds(work.pixel_bytes, work.pixel_flops,
                                      run.peaks)[0]
        spent += sum(op.us for op in ops[a:]) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
