"""data.host_ms_per_step (ms): the host's time in ``next()`` on the train
batch iterator that the benchmark hands the host loop (packing, the CSR
plan, the budget check), over the window's train steps, on the host
clock.  Nothing to read on routes without host batches."""


def read(ctx):
    if not ctx.window_steps:
        return None
    return 1e3 * ctx.host_next_s / ctx.window_steps
