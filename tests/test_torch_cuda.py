"""The port's CUDA kernels on the card, each against its plain PyTorch
version (marker ``gpu``; each test skips where there is no CUDA card).

On a machine with the card, from the repository root (no JAX needed, hence
no conftest):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

Tolerance: float32 sums in another order, rtol=1e-5, atol=1e-5*max|ref|.
"""

import numpy as np
import pytest
import torch

from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
from graph_hscn_tpu_torch.data.synthetic import make_voc_superpixels
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (edge_sddmm,
                                                        edge_sddmm_plain)
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_spmm, csr_spmm_plain

pytestmark = pytest.mark.gpu


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def assert_close(got, ref):
    ref = ref.detach().float().cpu()
    torch.testing.assert_close(got.detach().float().cpu(), ref, rtol=1e-5,
                               atol=1e-5 * max(float(ref.abs().max()), 1e-6))


@pytest.fixture(scope="module")
def batch():
    graphs = make_voc_superpixels(num_graphs=16, seed=51)
    b = pack_batch(graphs, PadBudget.for_dataset(graphs, 16),
                   with_spmm_plan=True)
    return b


@pytest.mark.parametrize("f", [64, 21, 1, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_matches_plain(batch, f, dtype):
    need_card()
    p = batch.spmm.to("cuda")
    n = p.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
    w = torch.rand(p.col.numel(), device="cuda", generator=gen)
    before = csr_spmm.launches
    for rp, col, ww in ((p.row_ptr, p.col, w),
                        (p.t_row_ptr, p.t_col, w[p.t_order])):
        out = csr_spmm(x, rp, col, ww)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (n, f)
        assert_close(out, csr_spmm_plain(x, rp, col, ww))
    assert csr_spmm.launches == before + 2


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_edge_sddmm_matches_plain(batch, dtypes):
    need_card()
    p = batch.spmm.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    hs = torch.randn(p.num_nodes, 64, device="cuda", generator=gen)
    hd = torch.randn(p.num_nodes, 64, device="cuda", generator=gen)
    hs, hd = hs.to(dtypes[0]), hd.to(dtypes[1])
    before = edge_sddmm.launches
    out = edge_sddmm(hs, hd, p.row, p.col, p.num_edges)
    torch.cuda.synchronize()
    assert edge_sddmm.launches == before + 1
    assert_close(out, edge_sddmm_plain(hs, hd, p.row, p.col, p.num_edges))
    assert not out[p.num_edges:].any()


@pytest.mark.parametrize("weight_needs_grad", [False, True])
def test_gather_scatter_grads_match_cpu(batch, weight_needs_grad):
    """The kernel path's forward and gradients on the card against the same
    autograd.Function on the CPU (plain versions)."""
    need_card()
    n, e = batch.num_nodes_padded, batch.num_edges_padded
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.normal(size=(n, 32)).astype(np.float32))
    w0 = torch.tensor(rng.uniform(0.5, 1.5, e).astype(np.float32))
    g = torch.tensor(rng.normal(size=(n, 32)).astype(np.float32))
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        res = {}
        for dev in ("cpu", "cuda"):
            b = batch.to(dev)
            x = x0.to(dev, copy=True).requires_grad_()
            w = w0.to(dev, copy=True).requires_grad_()
            out = spmm.gather_scatter(x, b.senders, b.receivers,
                                      edge_weight=w, plan=b.spmm,
                                      weight_needs_grad=weight_needs_grad)
            out.backward(g.to(dev))
            res[dev] = (out, x.grad, w.grad)
    finally:
        spmm.set_backend(prev)
    (out_c, dx_c, dw_c), (out_g, dx_g, dw_g) = res["cpu"], res["cuda"]
    assert_close(out_g, out_c)
    assert_close(dx_g, dx_c)
    if weight_needs_grad:
        assert_close(dw_g, dw_c)
    else:
        assert dw_g is None and dw_c is None


def test_wrappers_refuse_what_the_kernels_do_not_take(batch):
    need_card()
    p = batch.spmm.to("cuda")
    n = p.num_nodes
    x = torch.randn(n, 8, device="cuda")
    w = torch.rand(p.col.numel(), device="cuda")
    with pytest.raises(TypeError):
        csr_spmm(x.double(), p.row_ptr, p.col, w)
    with pytest.raises(TypeError):
        csr_spmm(x, p.row_ptr.long(), p.col, w)
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmm(torch.randn(8, n, device="cuda").t(), p.row_ptr, p.col, w)
    with pytest.raises(ValueError, match="rows"):
        csr_spmm(x[:-1], p.row_ptr, p.col, w)
    with pytest.raises(ValueError, match="cpu"):
        csr_spmm(x, p.row_ptr.cpu(), p.col, w)
    with pytest.raises(TypeError):
        edge_sddmm(x.half(), x, p.row, p.col, p.num_edges)


def test_run_experiment_on_the_card_launches_the_kernel():
    need_card()
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.runner import run_experiment
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GCN"
                      / "voc_superpixels_GCN_sparse.yaml")
    cfg.data.num_graphs = 24
    cfg.mpnn.num_layers = 2
    cfg.training.epochs = 1
    before = csr_spmm.launches
    result = run_experiment(cfg)
    assert np.isfinite(result.history[0]["train_loss"])
    assert csr_spmm.launches - before == (2 * 2 * result.num_train_steps
                                          + 2 * result.num_eval_batches)
