"""sample_p95_ms: the 95th percentile of the window's sampler calls, each
from the image's copy to the card until its probabilities are on the host."""

import numpy as np


def read(ctx):
    return 1000.0 * float(np.percentile(ctx.per_unit, 95))
