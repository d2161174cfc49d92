"""forward_host_ms.train: wall ms a step of the train step's one-hot,
forward and objective up to the loss (span `train_step.forward`) in the
traced window, which the profiler stretches: compare commits, not the
untraced wall."""

from portbench.spans import wall_ms_per_unit


def read(ctx):
    return wall_ms_per_unit(ctx, "train_step.forward", "train_step")
