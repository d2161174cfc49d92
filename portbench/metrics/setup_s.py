"""setup_s: seconds from process start to the first timed unit: imports,
the card's start, weights, data, building, warm-up and the checked steps."""


def read(ctx):
    return ctx.setup_s
