"""Device ms a batch of placement, the write pass and DC undiff: every
device operation of a traced batch after the sync's last exit-kernel
launch and before the pixel stage's first kernel (the stream kernel and
the scatter's torch ops, or the store kernel, with the write bases'
prefix sums and the undiff)."""
from perfbench import tracing

AFTER = ("exits_kernel",)                    # the sync's last launch
BEFORE = ("pixels_kernel", "idct_kernel")    # the pixel stage's first


def read(run):
    if run.trace is None:
        return None
    times = []
    for ops in run.trace.batches:
        a, b = tracing.last_index(ops, AFTER), tracing.first_index(ops, BEFORE)
        if a < 0 or b <= a + 1:
            continue
        times.append(sum(op.us for op in ops[a + 1:b]) / 1e3)
    return sum(times) / len(times) if times else None
