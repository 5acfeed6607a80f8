"""The port's fused GCN stack (ops/fused_gcn.py, models/fused_gcn.py)
against the JAX package's, which runs its Pallas kernels in interpret mode
as tests/test_fused_gcn.py does: forward and gradients in float32 and
bfloat16, without dropout and with the same external dropout bits; the
Philox generator of the seeded dropout; FusedDenseGCN with the weights
carried across; that the card's bf16 tolerance fails a kernel that leaves
out one bf16 rounding point; and the in-order products its bf16 reference
is computed with.

Tolerance: float32 rtol=1e-5, atol=1e-5*max|ref| (sums in another order).
bfloat16: both round the same float32 values at the same points, so the
forward and dx agree to the same 1e-5; dW and db sum bfloat16 products in
float32 in another order, held at 1e-5 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.models.fused_gcn import FusedDenseGCN as JaxFusedDenseGCN
from graph_hscn_tpu.ops.pallas.fused_gcn_kernel import (_folded_operator,
                                                        fused_gcn_stack
                                                        as jax_stack)
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.models.convert import (fused_gcn_params_from_jax,
                                                 mpnn_params_from_jax)
from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
from graph_hscn_tpu_torch.models.mpnn import MPNN
from graph_hscn_tpu_torch.ops.fused_gcn import (SMEM_LIMIT, THREADS,
                                                ProductsInOrder,
                                                dropout_bits_plain,
                                                dropout_threshold,
                                                folded_operator,
                                                fused_gcn_bwd,
                                                fused_gcn_fwd,
                                                fused_gcn_fwd_plain,
                                                fused_gcn_stack, fused_plan,
                                                philox4x32_10, plan_smem)

DIMS = [9, 16, 16, 10]


def assert_close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.fixture(scope="module")
def setup():
    """x [3, 32, 9], a symmetric adjacency on the first 24 nodes of each
    slot (the rest are padding), weights, biases, dropout bits and an output
    cotangent, all from one numpy seed."""
    rng = np.random.default_rng(0)
    G, S = 3, 32
    x = rng.normal(size=(G, S, DIMS[0])).astype(np.float32)
    adj = np.zeros((G, S, S), np.float32)
    for g in range(G):
        for _ in range(60):
            i, j = rng.integers(0, 24, 2)
            if i != j:
                adj[g, i, j] = adj[g, j, i] = 1.0
    params = [{"kernel": (0.3 * rng.normal(size=(DIMS[i], DIMS[i + 1])))
               .astype(np.float32),
               "bias": (0.1 * rng.normal(size=DIMS[i + 1])).astype(np.float32)}
              for i in range(3)]
    bits = [rng.integers(0, 2 ** 32, size=(G, S, f), dtype=np.uint32)
            for f in DIMS[1:-1]]
    cot = rng.normal(size=(G, S, DIMS[-1])).astype(np.float32)
    return x, adj, params, bits, cot


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stack_matches_jax(setup, dtype, rate):
    x, adj, params, bits, cot = setup
    jdrop = {"bits": [jnp.asarray(b) for b in bits]} if rate else None

    def jf(x, p):
        return jax_stack(x.astype(dtype), jnp.asarray(adj), p, jdrop, rate,
                         True)

    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    ref, vjp = jax.vjp(jf, jnp.asarray(x), jp)
    jdx, jdp = vjp(jnp.asarray(cot))

    xt = torch.tensor(x).requires_grad_()
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in params]
    tdrop = ({"bits": [torch.from_numpy(b.view(np.int32)) for b in bits]}
             if rate else None)
    before = fused_gcn_fwd.launches, fused_gcn_bwd.launches
    out = fused_gcn_stack(xt.to(getattr(torch, dtype)), torch.tensor(adj),
                          tp, tdrop, rate)
    out.backward(torch.tensor(cot))
    # The CPU runs the plain versions: no kernel launch is counted.
    assert (fused_gcn_fwd.launches, fused_gcn_bwd.launches) == before
    assert out.dtype == torch.float32
    assert_close(out.detach(), ref)
    assert_close(xt.grad, jdx)
    for l in range(3):
        assert tp[l]["kernel"].grad.dtype == torch.float32
        assert_close(tp[l]["kernel"].grad, jdp[l]["kernel"])
        assert_close(tp[l]["bias"].grad, jdp[l]["bias"])


def test_folded_operator_matches_jax(setup):
    _, adj, *_ = setup
    assert_close(folded_operator(torch.tensor(adj)),
                 _folded_operator(jnp.asarray(adj)))
    assert_close(folded_operator(torch.tensor(adj), add_self_loops=False),
                 _folded_operator(jnp.asarray(adj), add_self_loops=False))


def test_philox_known_answer():
    """Random123's known-answer vector for Philox4x32-10: counter 0, key 0
    -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8; and all-ones counter and key
    -> 408f276d 41c83b0e a20bc7c6 6d5451fd."""
    z = torch.zeros(1, dtype=torch.int64)
    assert [int(w) for w in philox4x32_10(z, z, z, z, 0, 0)] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(w) for w in philox4x32_10(f, f, f, f, 0xFFFFFFFF,
                                          0xFFFFFFFF)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_seeded_dropout_bits_statistics():
    """The seeded stream: the counter layout (word element % 4 of the
    Philox block element // 4 of (layer, graph)), the drop rate, and
    distinct streams for distinct seeds, layers and graphs."""
    bits = dropout_bits_plain(12345, 4, 32, 16, 1)
    assert bits.shape == (4, 32, 16) and bits.dtype == torch.int64
    assert 0 <= int(bits.min()) and int(bits.max()) < 2 ** 32
    c = torch.tensor([5], dtype=torch.int64)     # element 22 of graph 2
    words = philox4x32_10(c, torch.ones_like(c), 2 * torch.ones_like(c),
                          torch.zeros_like(c), 12345, 0)
    assert int(bits[2, 1, 6]) == int(words[2])
    rate = 0.3
    dropped = (bits < dropout_threshold(rate)).float().mean()
    assert abs(float(dropped) - rate) < 0.03
    assert not torch.equal(bits, dropout_bits_plain(12346, 4, 32, 16, 1))
    assert not torch.equal(bits, dropout_bits_plain(12345, 4, 32, 16, 0))
    assert not torch.equal(bits[0], bits[1])


def test_seeded_dropout_forward(setup):
    """dropout={"seed": s} is the bits form with the Philox bits."""
    x, adj, params, *_ = setup
    a_hat = folded_operator(torch.tensor(adj))
    x = torch.tensor(x)
    ws = [torch.tensor(p["kernel"]) for p in params]
    bs = [torch.tensor(p["bias"]) for p in params]
    G, S, _ = x.shape
    seeded = fused_gcn_fwd(a_hat, x, ws, bs, 0.3, {"seed": 99})
    bits = [dropout_bits_plain(99, G, S, f, l).to(torch.int32)
            for l, f in enumerate(DIMS[1:-1])]
    given = fused_gcn_fwd_plain(a_hat, x, ws, bs, 0.3, {"bits": bits})
    for a, b in zip(seeded, given):
        assert torch.equal(a, b)
    tensor_seed = fused_gcn_fwd(a_hat, x, ws, bs, 0.3,
                                {"seed": torch.tensor([99])})
    assert torch.equal(tensor_seed[-1], seeded[-1])
    with pytest.raises(ValueError, match="dropout"):
        fused_gcn_fwd(a_hat, x, ws, bs, 0.3, None)
    with pytest.raises(ValueError, match="bit arrays"):
        fused_gcn_fwd(a_hat, x, ws, bs, 0.3, {"bits": bits[:1]})


def _stack_without(skip, a_hat, x, ws, bs, bits, g, rate):
    """The plain forward and backward in bfloat16 with the rounding point
    ``skip`` left out ("y", "hidden", "dz", "dy"; None leaves all in):
    what a kernel with that fault computes.  Returns (outs, grads)."""
    cd, f32 = torch.bfloat16, torch.float32
    keep = [(b.to(torch.int64) & 0xFFFFFFFF) >= dropout_threshold(rate)
            for b in bits]
    scale = float(np.float32(1.0 / (1.0 - rate)))
    h, outs = x, []
    for l in range(3):
        y = torch.matmul(h.float(), ws[l].float())
        y = y if skip == "y" else y.to(cd).float()
        z = torch.bmm(a_hat.float(), y) + bs[l]
        if l < 2:
            h = torch.where(keep[l], torch.relu(z) * scale, 0.0)
            h = h if skip == "hidden" else h.to(cd)
        else:
            h = z
        outs.append(h)
    dz, dws, dbs, dx = g, [None] * 3, [None] * 3, None
    for l in range(2, -1, -1):
        h_prev = (x if l == 0 else outs[l - 1]).float()
        dbs[l] = dz.sum(dim=(0, 1))
        dzc = dz if skip == "dz" else dz.to(cd).to(f32)
        dy = torch.bmm(a_hat.float().transpose(1, 2), dzc)
        dy = dy if skip == "dy" else dy.to(cd).float()
        dws[l] = torch.einsum("gsk,gso->ko", h_prev, dy)
        dh = torch.matmul(dy, ws[l].float().t())
        if l > 0:
            dz = dh * torch.where(h_prev > 0, scale, 0.0)
        else:
            dx = dh.to(cd)
    return outs, [dx] + dws + dbs


@pytest.mark.parametrize("skip", ["y", "hidden", "dz", "dy"])
def test_bf16_tolerance_catches_a_missing_rounding_point(setup, skip):
    """The card's bf16 tolerance (1e-4*max|ref| an output, chip_smoke.py
    and tests/test_torch_cuda.py) fails a kernel that leaves out one of
    the Pallas kernel's bf16 rounding points: its error stands far above
    the tolerance, while the transcription with every point in place
    equals the plain version bit for bit."""
    x, adj, params, bits, cot = setup
    cd = torch.bfloat16
    a_hat = folded_operator(torch.tensor(adj)).to(cd)
    xb = torch.tensor(x).to(cd)
    ws = [torch.tensor(p["kernel"]).to(cd) for p in params]
    bs = [torch.tensor(p["bias"]) for p in params]
    tbits = [torch.from_numpy(b.view(np.int32)) for b in bits]
    g = torch.tensor(cot)
    ref_out = fused_gcn_fwd_plain(a_hat, xb, ws, bs, 0.3, {"bits": tbits})
    dx, dws, dbs = fused_gcn_bwd(a_hat, xb, ws, ref_out[:-1], g, 0.3)
    refs = ref_out + [dx] + dws + dbs

    def worst(skip):
        outs, grads = _stack_without(skip, a_hat, xb, ws, bs, tbits, g, 0.3)
        return max(float((o.float() - r.float()).abs().max())
                   / (1e-4 * float(r.float().abs().max()))
                   for o, r in zip(outs + grads, refs))

    assert worst(None) == 0.0
    assert worst(skip) > 1.0


@pytest.mark.parametrize("product", ["bmm", "bmm_transposed", "matmul"])
def test_products_in_order_sum_in_order(product):
    """ProductsInOrder, under which plain_reference runs the bf16 plain
    versions: torch.bmm and torch.matmul (a batched [G, S, K] @ [K, N])
    sum k = 0, 1, .. in order, an explicit loop's bits; other calls run as
    they are."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(3, 40, 40, generator=gen)
    b = (torch.randn(40, 6, generator=gen) if product == "matmul"
         else torch.randn(3, 40, 6, generator=gen))
    if product == "bmm_transposed":
        a = a.transpose(1, 2)
    fn = torch.matmul if product == "matmul" else torch.bmm
    loop = torch.zeros(3, 40, 6)
    for k in range(40):
        loop = loop + a[:, :, k:k + 1] * b[..., k:k + 1, :]
    with ProductsInOrder():
        got = fn(a, b)
        total = torch.add(a, 1.0).sum()
    assert torch.equal(got, loop)
    assert torch.equal(total, torch.add(a, 1.0).sum())


def test_kernel_wrappers_refuse_non_cuda_devices():
    x = torch.empty(2, 8, 9, device="meta")
    a = torch.empty(2, 8, 8, device="meta")
    ws = [torch.empty(9, 4, device="meta")]
    bs = [torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        fused_gcn_fwd(a, x, ws, bs)
    with pytest.raises(ValueError, match="CUDA"):
        fused_gcn_bwd(a, x, ws, [], torch.empty(2, 8, 4, device="meta"))


def _peptides_batch(num_graphs=5, seed=101):
    graphs = js.make_peptides_func(num_graphs=num_graphs, seed=seed,
                                   mean_nodes=30)
    slot = ((max(g.num_nodes for g in graphs) + 7) // 8) * 8
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs,
                                                            num_graphs),
                           slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs,
                                                            num_graphs),
                           slot_nodes=slot).to("cpu")
    return jbatch, tbatch


@pytest.mark.parametrize("readout", ["mean", "none"])
def test_fused_model_matches_jax(readout):
    """FusedDenseGCN with dropout off, weights carried across, logits and
    every gradient against the JAX model (interpret mode)."""
    jbatch, tbatch = _peptides_batch()
    jmodel = JaxFusedDenseGCN(hidden_channels=16, num_classes=10,
                              num_layers=3, readout=readout, interpret=True)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, train=False)["params"]
    ref, vjp = jax.vjp(
        lambda p: jmodel.apply({"params": p}, jbatch, train=False), params)
    cot = np.random.default_rng(5).normal(size=ref.shape).astype(np.float32)
    (jgrads,) = vjp(jnp.asarray(cot))

    model = FusedDenseGCN(9, 16, 10, 3, readout=readout)
    model.load_state_dict(fused_gcn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    out = model(tbatch)
    (out * torch.tensor(cot)).sum().backward()
    assert_close(out.detach(), ref)
    for name, p in model.named_parameters():
        assert_close(p.grad, jgrads[name])


def test_fused_model_equals_the_mpnn():
    """The port's fused model and its dense MPNN (relu, compat double relu
    on) compute the same function on the same weights."""
    _, tbatch = _peptides_batch(seed=102)
    fused = FusedDenseGCN(9, 16, 10, 3,
                          generator=torch.Generator().manual_seed(0))
    mpnn = MPNN(conv_type="gcn", activation="relu", num_features=9,
                hidden_channels=16, num_classes=10, num_layers=3)
    mpnn.load_state_dict(mpnn_params_from_jax({
        f"GCNConv_{i}": {"kernel": getattr(fused, f"kernel_{i}").detach(),
                         "bias": getattr(fused, f"bias_{i}").detach()}
        for i in range(3)}))
    fused.eval()
    mpnn.eval()
    g = tbatch.num_graphs_padded - 1
    assert_close(fused(tbatch).detach()[:g], mpnn(tbatch).detach()[:g])


def test_fused_model_init_and_dropout():
    """Glorot-uniform kernels [in, out] and zero biases from the generator;
    dropout needs an explicit generator and follows it."""
    _, tbatch = _peptides_batch(seed=103)
    a = FusedDenseGCN(9, 16, 10, 3, dropout=0.3,
                      generator=torch.Generator().manual_seed(4))
    b = FusedDenseGCN(9, 16, 10, 3, dropout=0.3,
                      generator=torch.Generator().manual_seed(4))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    k0 = a.kernel_0.detach()
    lim = np.sqrt(6.0 / (9 + 16))
    assert k0.shape == (9, 16) and float(k0.abs().max()) <= lim
    assert not a.bias_0.any()
    a.train()
    with pytest.raises(ValueError, match="generator"):
        a(tbatch)
    t1 = a(tbatch, generator=torch.Generator().manual_seed(1))
    t2 = a(tbatch, generator=torch.Generator().manual_seed(1))
    t3 = a(tbatch, generator=torch.Generator().manual_seed(2))
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    a.eval()
    assert torch.equal(a(tbatch), a(tbatch))
    with pytest.raises(ValueError, match="slotted"):
        a(tbatch.replace(slot=None))


def test_fused_params_from_jax_rejects_other_trees():
    with pytest.raises(ValueError, match="kernel_i"):
        fused_gcn_params_from_jax({"GCNConv_0": {}})


# The launch plan (ops/fused_gcn.py:fused_plan).  WIDE: the widths of
# configs/GCN/peptides_func_GCN_dp8.yaml (hidden 128, 5 layers).
WIDE = [9, 128, 128, 128, 128, 10]


def _r4(f):
    return (f + 3) & ~3


def _old_kernels_took(slot, dims, backward):
    """The shared-memory check of the one-block-a-graph kernels that the
    clustered ones replaced (float32 y, W, dz and dy in shared memory)."""
    fp, fin = max(_r4(f) for f in dims[1:]), max(dims[:-1])
    need = 4 * fp * (slot + fin) + (4 * (fp + 1) * slot if backward else 0)
    return slot % 4 == 0 and need <= SMEM_LIMIT


def _check_plan(plan, graphs, slot, dims, dtype, backward):
    assert plan.cluster in (4, 8)
    assert plan.blocks == graphs * plan.cluster
    assert plan.blocks % plan.cluster == 0
    # The blocks' ranges cover 0..S-1 exactly once.
    owned = [i for lo, hi in plan.ranges(slot) for i in range(lo, hi)]
    assert owned == list(range(slot))
    assert all((hi - lo) % 4 == 0 for lo, hi in plan.ranges(slot))
    assert plan.rows == _r4(-(-slot // plan.cluster))
    assert plan.jt % 4 == 0 and 4 <= plan.jt <= slot
    fp = max(_r4(f) for f in dims[1:])
    assert plan.fc % 4 == 0 and 4 <= plan.fc <= fp
    assert (plan.rows // 4) * (plan.fc // 4) <= THREADS
    esize = 2 if dtype == torch.bfloat16 else 4
    aux = (fp if backward else max([_r4(f) for f in dims[1:-1]] + [0])) + 1
    assert plan.smem == plan_smem(slot, plan.rows, plan.jt, plan.fc,
                                  plan.resident, esize, fp, aux, backward)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [DIMS, WIDE], ids=["h16", "h128"])
def test_fused_plan_every_slot(dims, dtype, backward):
    """Every slot 8..512 (step 8) at the fused peptides widths and at
    hidden 128 gets a plan: ranges that cover the slot exactly once, tiles
    within a block's threads, shared memory within the card's 232,448
    bytes; every shape the old kernels took among them too."""
    for slot in range(8, 513, 8):
        plan = fused_plan(32, slot, dims, dtype, backward)
        assert plan is not None, slot
        _check_plan(plan, 32, slot, dims, dtype, backward)
    if dims == DIMS:   # the A_hat slice stays resident at these widths
        assert all(fused_plan(32, s, dims, dtype, backward).resident
                   for s in range(8, 513, 8))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plan_takes_every_shape_the_old_kernels_took(dtype, backward):
    """Slots up to the old kernels' limit (3,616 at the peptides widths,
    far beyond the 512 of dense slots), widths up to 236, 1 to 8 layers:
    each shape they took gets a plan, streaming A_hat where its slice does
    not fit even in clusters of 8."""
    rng = np.random.default_rng(11)
    shapes = [(s, DIMS) for s in (516, 1024, 2048, 3612, 3616)]
    for _ in range(300):   # random widths, a random slot the old took
        layers = int(rng.integers(1, 9))
        dims = [int(f) for f in rng.integers(1, 237, size=layers + 1)]
        top = max((s for s in range(4, 14600, 4)
                   if _old_kernels_took(s, dims, backward)), default=0)
        if top:
            shapes += [(top, dims), (4 * int(rng.integers(1, top // 4 + 1)),
                                     dims)]
    shapes += [(4, [236, 236]), (14524, [1, 1]), (8, [9, 236, 236, 10])]
    took = streamed = 0
    for slot, dims in shapes:
        if not _old_kernels_took(slot, dims, backward):
            continue
        took += 1
        plan = fused_plan(3, slot, dims, dtype, backward)
        assert plan is not None, (slot, dims)
        _check_plan(plan, 3, slot, dims, dtype, backward)
        streamed += not plan.resident
    assert took > 300 and streamed > 0


def test_fused_plan_peptides_batch():
    """The fused peptides batch (G=32, S=392, 9 -> 16 -> 16 -> 10): clusters
    of 4 (128 blocks, about one an SM), 100 rows a block, A_hat resident and
    y staged whole; at S=512 and hidden 128, clusters of 8, still resident.
    A shape no plan fits gives None."""
    for backward in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            plan = fused_plan(32, 392, DIMS, dtype, backward)
            assert (plan.cluster, plan.rows, plan.resident, plan.jt,
                    plan.blocks) == (4, 100, True, 392, 128)
        wide = fused_plan(32, 512, WIDE, torch.float32, backward)
        assert (wide.cluster, wide.rows, wide.resident) == (8, 64, True)
    assert fused_plan(1, 8, [9, 8192, 10], torch.float32) is None
