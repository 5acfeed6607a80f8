"""host_loop.step_ms (ms): on the host loop, the host's wall time in one
train step of the window's epochs, read as ``train_step.host_ms`` reads
it (the port's ``train_step`` spans: the batch made on the device and the
step issued).  Nothing to read from a program without spans."""

from hscnbench import manifest


def read(ctx):
    return manifest.metric_reader("train_step.host_ms").read(ctx)
