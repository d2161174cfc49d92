"""backward_host_ms.train: wall ms a step of the train step's zero_grad and
backward (span `train_step.backward`) in the traced window, which the
profiler stretches: compare commits, not the untraced wall."""

from portbench.spans import wall_ms_per_unit


def read(ctx):
    return wall_ms_per_unit(ctx, "train_step.backward", "train_step")
