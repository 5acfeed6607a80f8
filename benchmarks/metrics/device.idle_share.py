"""device.idle_share (%): 1 - (the union of the device operations'
intervals) / the traced slice's wall time, from ``torch.profiler``."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
