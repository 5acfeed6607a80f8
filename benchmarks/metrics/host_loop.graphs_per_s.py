"""host_loop.graphs_per_s (graphs/s): on the host loop, the train graphs
of the measured window's epochs over its wall time, as
``train_graphs_per_s`` counts them.  Per layer and not end to end there:
the host loop keeps its card idle most of the time, so its rate follows
the speed of the host's shared cores, which drifts by more between runs
than an end-to-end bound may allow."""


def read(ctx):
    w = ctx.window
    return w.epochs * len(ctx.split["train"]) / w.wall_s
