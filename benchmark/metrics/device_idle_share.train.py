"""Per cent of the traced stretch of a training cell in which no operation
ran on the card (device trace)."""

from benchmark.metrics._shared import idle_share


def read(ctx):
    return idle_share(ctx, "steps")
