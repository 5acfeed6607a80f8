"""csr_spmm_roofline (%): the least time of the traced slice's
``csr_spmm`` launches over their summed device time.

A launch's least time is max(bytes / peak bytes/s, ops / peak FLOP/s);
its bytes are row_ptr (N + 1 rows), col and w (E real edges), the rows of
x its edges read (the batch's real nodes), out (N rows) written once, and
on a transpose the order array (E int64); its ops 2·E·F.  N is the padded
batch's rows, E its real edges, F the width; the widths of a train step's
launches are the configuration's (``configs/<config>.py:spmm_launches``),
forwards then transposes, and an eval batch's the forwards alone (the
evals that the cadence puts in the slice).  Where the trace, or the
wrapper's own launch counter, holds another number of launches than that
count gives, nothing is read."""

from hscnbench.peaks import least_time

KERNEL = "csr_spmm_kernel"


def launch_time(n_pad, n_real, edges, width, transpose):
    nbytes = 4 * (n_pad + 1) + 8 * edges + 4 * width * (n_real + n_pad)
    if transpose:
        nbytes += 8 * edges
    return least_time(nbytes, 2 * edges * width)


def read(ctx):
    if ctx.trace is None or not ctx.slice_batches:
        return None
    widths = ctx.cell.reference.spmm_launches(ctx.cell.config, ctx.dims)
    half = len(widths) // 2
    seconds, count = ctx.trace.op_seconds(KERNEL)
    want = (len(widths) * len(ctx.slice_batches)
            + half * len(ctx.slice_eval_batches))
    if (count != want or ctx.slice_launches.get("csr_spmm") != want
            or seconds <= 0):
        return None
    least = sum(launch_time(n_pad, n_real, e, f, i >= half)
                for n_pad, n_real, e in ctx.slice_batches
                for i, f in enumerate(widths))
    least += sum(launch_time(n_pad, n_real, e, f, False)
                 for n_pad, n_real, e in ctx.slice_eval_batches
                 for f in widths[:half])
    return 100.0 * least / seconds
