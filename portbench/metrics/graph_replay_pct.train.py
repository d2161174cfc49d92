"""graph_replay_pct.train: the share of the traced window's train steps that
replayed a captured CUDA graph, 100 x the `train_step.replay` spans over the
`train_step` spans; None where no step replayed one (a program whose step
has no graph, as an older commit, or a step that ran eagerly)."""

from portbench.spans import records


def read(ctx):
    replays, steps = records(ctx, "train_step.replay"), records(ctx, "train_step")
    if replays is None or steps is None:
        return None
    return 100.0 * len(replays) / len(steps)
