"""step_offcpu_ms.train: the mean over the `train_step` spans of their wall ms
less the loop thread's CPU ms over them: the time that thread waits inside
the step (on autograd's device thread in the backward, or for the
interpreter lock), in the traced window, which the profiler stretches:
compare commits, not the untraced wall."""

from portbench.spans import offcpu_ms


def read(ctx):
    return offcpu_ms(ctx, "train_step")
