"""Host milliseconds an eval batch spends in the trainer's dispatch call
(``eval_metrics_k``: staging the K batches and the graph's replay) over
the untraced window."""

from benchmark.harness import readers


def read(ctx):
    return readers.dispatch_host_ms(ctx)
