"""train_step.device_ms (ms): the device's busy time in the traced slice
(the union of its operations' intervals) over the train steps in it."""


def read(ctx):
    if not ctx.slice_steps:
        return None
    return 1e3 * ctx.trace.busy_s() / ctx.slice_steps
