"""Share of the traced eval window in which no kernel runs on the device
(copies and fills count as idle)."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
