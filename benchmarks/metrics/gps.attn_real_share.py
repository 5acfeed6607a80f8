"""gps.attn_real_share (%): of the query-key pairs a train epoch's
attention scores, the share between two real nodes of one graph: the
port's counters ``gps.attn.pairs_real`` (the train graphs' squared node
counts, summed) over ``gps.attn.pairs_computed`` (the pairs the attention
module says it scores over the epoch's slot blocks), counted once at the
fit's set-up.  Nothing to read without the counters."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "counter_totals", dict)()

    def total(name):
        return sum(v for (n, _), v in totals.items() if n == name)
    computed = total("gps.attn.pairs_computed")
    return 100.0 * total("gps.attn.pairs_real") / computed if computed \
        else None
