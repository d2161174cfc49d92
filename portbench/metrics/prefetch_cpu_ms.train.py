"""prefetch_cpu_ms.train: the prefetch thread's CPU ms a batch: the change of
its CPU clock, read at the entry of each `data.wait` span, from the first
wait of the traced window to the last, over the waits between. The thread
makes and queues batches; the traced window's profiler does not see it, but
contends with it for the interpreter lock."""

from portbench.spans import value_rate_ms


def read(ctx):
    return value_rate_ms(ctx, "data.wait")
