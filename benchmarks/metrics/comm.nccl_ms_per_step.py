"""comm.nccl_ms_per_step (ms): device time of the NCCL kernels (the halo
exchange, the loss and gradient all_reduce, the logits' all_gather) in
the traced slice, over its train steps, on rank 0."""

from hscnbench.trace import kernel_name


def read(ctx):
    if ctx.trace is None or not ctx.slice_steps:
        return None
    ns = sum(e - s for n, s, e in ctx.trace.ops
             if kernel_name(n).startswith("nccl"))
    return 1e-6 * ns / ctx.slice_steps if ns else None
