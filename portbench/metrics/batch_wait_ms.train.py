"""batch_wait_ms.train: host ms per step that the loop waits for its next
batch from the prefetch thread and its copy to the card (untraced window)."""


def read(ctx):
    return 1000.0 * sum(ctx.per_unit) / ctx.units
