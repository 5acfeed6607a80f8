"""GraphMHA's attention on the CPU (``ops/cuda/graph_attn_kernel.py``): the
plain version that CPU tensors take is the stock-op attention GraphMHA ran
before the kernels, bit for bit (output, input and weight gradients, the
dropout generator's offset); the pairs each route scores; the wrappers'
checks.  The kernels themselves run on the card alone
(``tests/test_torch_cuda.py``, ``-k graph_attn``)."""

import math

import numpy as np
import pytest
import torch

from graph_hscn_tpu_torch.models.gps import GraphMHA
from graph_hscn_tpu_torch.models.layers import dropout
from graph_hscn_tpu_torch.ops.cuda import graph_attn_kernel as ga

HIDDEN, HEADS = 16, 4


def parent_forward(mha: GraphMHA, xb, mask, generator=None):
    """GraphMHA.forward as it was before the kernels, op for op."""
    G, S, _ = xb.shape
    nh, hd = mha.num_heads, mha.head_dim

    def proj(dense):
        return dense(xb).reshape(G, S, nh, hd)

    q, k, v = proj(mha.query), proj(mha.key), proj(mha.value)
    scores = torch.einsum("gqhd,gkhd->ghqk", q, k) / math.sqrt(hd)
    bias = torch.where(mask, 0.0, -1e9)[:, None, None, :]
    attn = torch.softmax((scores + bias.to(scores.dtype)).float(), -1)
    attn = dropout(attn, mha.dropout, mha.training, generator)
    out = torch.einsum("ghqk,gkhd->gqhd", attn.to(v.dtype), v)
    out = mha.out(out.reshape(G, S, nh * hd))
    return torch.where(mask[:, :, None], out, 0.0)


def blocks(seed: int = 3):
    """[G=4, S=40, H] blocks: a full slot, padding rows, no real node (the
    dummy slot) and one node."""
    rng = np.random.default_rng(seed)
    G, S = 4, 40
    xb = torch.tensor(rng.normal(size=(G, S, HIDDEN)).astype(np.float32))
    mask = torch.zeros(G, S, dtype=torch.bool)
    for g, n in enumerate((40, 27, 0, 1)):
        mask[g, :n] = True
    return xb, mask


def run(forward, mha, xb, mask, seed):
    """Output, input gradient, weight gradients and the generator's next
    draw after one forward and backward from generator seed ``seed``."""
    mha.zero_grad()
    x = xb.clone().requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    out = forward(mha, x, mask, gen)
    cot = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
    (out * cot).sum().backward()
    grads = {k: p.grad.clone() for k, p in mha.named_parameters()}
    return out.detach(), x.grad, grads, torch.rand(8, generator=gen)


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.5, True),
                                           (0.5, False)])
def test_plain_route_is_the_parents_graph_mha_bit_for_bit(rate, training):
    """On CPU tensors GraphMHA (the plain version) gives the parent's
    output, input and weight gradients bit for bit, with dropout on (0.5 in
    training) and off (rate 0, eval), and leaves the generator where the
    parent's forward left it."""
    xb, mask = blocks()
    mha = GraphMHA(HIDDEN, HEADS, generator=torch.Generator().manual_seed(1),
                   dropout=rate)
    mha.train(training)
    got = run(lambda m, x, mk, g: m(x, mk, g), mha, xb, mask, 7)
    want = run(parent_forward, mha, xb, mask, 7)
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(a, b)
    assert got[2].keys() == want[2].keys()
    for name in got[2]:
        assert torch.equal(got[2][name], want[2][name]), name
    if training and rate:
        # The draw happened: the weights differ from the undropped ones.
        mha.eval()
        assert not torch.equal(got[0], mha(xb, mask))


@pytest.mark.parametrize("rate,training,draws", [(0.5, True, True),
                                                 (0.0, True, False),
                                                 (0.5, False, False)])
def test_a_forward_takes_the_parents_generator_offset(rate, training,
                                                      draws):
    """The plain route draws one uniform [G, nh, S, S] block where the
    parent drew it, and nothing at rate 0 or in eval: the generator's next
    numbers after a forward are the parent's, and they are the numbers
    after exactly that draw (or after none)."""
    xb, mask = blocks()
    G, S = mask.shape
    mha = GraphMHA(HIDDEN, HEADS, generator=torch.Generator().manual_seed(1),
                   dropout=rate)
    mha.train(training)
    gen = torch.Generator().manual_seed(11)
    mha(xb, mask, gen)
    ref = torch.Generator().manual_seed(11)
    parent_forward(mha, xb, mask, ref)
    expect = torch.Generator().manual_seed(11)
    if draws:
        torch.rand((G, HEADS, S, S), generator=expect)
    after = torch.rand(16, generator=gen)
    assert torch.equal(after, torch.rand(16, generator=ref))
    assert torch.equal(after, torch.rand(16, generator=expect))


def test_graph_attention_on_cpu_is_the_plain_version():
    """graph_attention on CPU tensors returns graph_attention_plain's
    result, the same bits drawn."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 20, 2, 5, generator=g) for _ in range(3))
    mask = torch.arange(20)[None, :] < torch.tensor([[20], [7], [0]])
    a = ga.graph_attention(q, k, v, mask, 0.3, True,
                           torch.Generator().manual_seed(5))
    b = ga.graph_attention_plain(q, k, v, mask, 0.3, True,
                                 torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_pairs_computed_on_both_routes():
    """Blocks of slot 128 holding 0, 1, 32, 33 and 100 real nodes: the
    plain route scores every pair of every block (5 * 128^2); the kernels
    the tiles of 32 rows up to each graph's last real node, a hand count of
    0 + 32^2 + 32^2 + 64^2 + 128^2."""
    n = np.array([0, 1, 32, 33, 100])
    assert ga.TILE == 32
    assert GraphMHA.pairs_computed(n, 128, on_card=False) == 5 * 128 * 128
    assert GraphMHA.pairs_computed(n, 128, on_card=True) == (
        0 + 32 ** 2 + 32 ** 2 + 64 ** 2 + 128 ** 2)
    # No graph's padding past its last tile: at most every pair, at least
    # the real ones.
    rng = np.random.default_rng(0)
    n = rng.integers(0, 449, size=128)
    tiles = GraphMHA.pairs_computed(n, 448, on_card=True)
    assert int((n ** 2).sum()) <= tiles <= 128 * 448 ** 2


class _DeviceSet:
    """What count_attention_pairs reads of a device dataset."""

    def __init__(self, n_node, slot):
        self.n_node = torch.as_tensor(n_node)
        self.slot = slot


def test_count_attention_pairs_on_the_cpu_and_for_a_gcn():
    """count_attention_pairs of a GPS on the CPU counts the plain route's
    pairs (every pair of the epoch's blocks, 2 rows of 2 slots for 3
    graphs); a model without a GraphMHA counts nothing."""
    from graph_hscn_tpu_torch.models.gps import GPSModel
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    from graph_hscn_tpu_torch.train.loop import count_attention_pairs
    from graph_hscn_tpu_torch.utils import profiling

    ds = _DeviceSet([5, 9, 3, 7], 16)
    gps = GPSModel(9, 8, 10, 1, num_heads=2,
                   generator=torch.Generator().manual_seed(0))
    profiling.reset_spans()
    count_attention_pairs(gps, ds, [0, 1, 3], 2)
    assert profiling.counter_totals() == {
        ("gps.attn.pairs_real", None): 25 + 81 + 49,
        ("gps.attn.pairs_computed", None): 4 * 16 * 16}
    profiling.reset_spans()
    gcn = MPNN("gcn", "relu", 9, 8, 10, 1, generator=torch.Generator())
    count_attention_pairs(gcn, ds, [0, 1, 3], 2)
    assert profiling.counter_totals() == {}
    profiling.reset_spans()


def test_extent_is_one_past_the_last_real_node():
    """extent of prefix and non-prefix masks, and of a block with no real
    node: int32, one past the last True."""
    mask = torch.tensor([[1, 1, 1, 0, 0],
                         [0, 1, 0, 1, 0],
                         [0, 0, 0, 0, 0],
                         [1, 1, 1, 1, 1]], dtype=torch.bool)
    got = ga.extent(mask)
    assert got.dtype == torch.int32
    assert got.tolist() == [3, 4, 0, 5]


def test_the_kernel_wrappers_refuse_cpu_tensors():
    """graph_attn and graph_attn_bwd launch on CUDA tensors or raise: no
    fallback inside them (graph_attention picks the plain version)."""
    q = torch.zeros(1, 4, 1, 8)
    mask = torch.ones(1, 4, dtype=torch.bool)
    ext = ga.extent(mask)
    with pytest.raises(ValueError, match="CUDA"):
        ga.graph_attn(q, q, q, mask, ext)
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ga.graph_attn_bwd(q, q, q, q, q, mask, ext, lse)
    assert ga.graph_attn.launches == 0 and ga.graph_attn_bwd.launches == 0
