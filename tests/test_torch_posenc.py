"""The port's positional encodings (transform/posenc.py, models/signnet.py,
models/encoded.py) against the JAX package's, on the same numpy-seeded
graphs: the seven tests of tests/test_posenc_signnet.py and the two of
tests/test_pe_e2e.py carried over, each beside JAX.

Eigenvectors are free in sign and, within a degenerate eigenspace, in
basis, so the eigen solvers that differ (scipy's shift-invert, LOBPCG,
``torch.linalg.eigh``) are compared through invariants: eigenvalues, and
the projector onto the k smallest eigenvectors at a k where the spectrum
has a gap (asserted), within 1e-5.  ``compute_posenc_stats`` runs the JAX
package's numpy arithmetic and must agree bit for bit.  SignNet, the
EncodedModel and the frozen transform, from carried-over weights: outputs,
logits and gradients within 1e-5 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.config.config import PEConfig as JaxPEConfig
from graph_hscn_tpu.config.config import parse_config as jax_parse_config
from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu.models.encoded import \
    wrap_with_signnet as jax_wrap_with_signnet
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.models.signnet import \
    SignNetNodeEncoder as JaxSignNetNodeEncoder
from graph_hscn_tpu.runner import run_experiment as jax_run_experiment
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu.transform import posenc as jpe
from graph_hscn_tpu.utils.logger import Logger as JaxLogger
from graph_hscn_tpu_torch.config.config import PEConfig, parse_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (encoded_params_from_jax,
                                                 mpnn_params_from_jax,
                                                 signnet_params_from_jax)
from graph_hscn_tpu_torch.models.encoded import wrap_with_signnet
from graph_hscn_tpu_torch.models.mpnn import MPNN
from graph_hscn_tpu_torch.models.signnet import SignNetNodeEncoder
from graph_hscn_tpu_torch.runner import run_experiment
from graph_hscn_tpu_torch.transform import posenc as tpe
from graph_hscn_tpu_torch.utils.logger import Logger


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: the suite runs several workers on
    shared cores, where torch's thread pool oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def assert_close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-30))


def _path_graphs(n=6):
    src, dst = np.arange(n - 1), np.arange(1, n)
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    x = np.ones((n, 3), np.float32)
    return jb.GraphData(x=x, edge_index=ei), tb.GraphData(x=x, edge_index=ei)


def test_eigh_path_graph_spectrum():
    """Sym-normalized Laplacian of a path graph: eigenvalues in [0, 2],
    the smallest 0; N=6 < max_freqs=10 pads with NaN; L2-normalized
    columns; the eigen equation holds; and both packages' stats are the
    same bits."""
    jg, tg = _path_graphs(6)
    g = tpe.compute_posenc_stats(tg, max_freqs=10)
    ref = jpe.compute_posenc_stats(jg, max_freqs=10)
    np.testing.assert_array_equal(g.eigvals, ref.eigvals)
    np.testing.assert_array_equal(g.eigvecs, ref.eigvecs)
    vals = g.eigvals[0]
    assert abs(vals[0]) < 1e-6
    assert np.isnan(vals[6:]).all() and np.isnan(g.eigvecs[:, 6:]).all()
    for k in range(6):
        np.testing.assert_allclose(np.linalg.norm(g.eigvecs[:, k]), 1.0,
                                   rtol=1e-5)
    lap = tpe._sym_laplacian(tg, "sym")
    v = g.eigvecs[:, 1]
    np.testing.assert_allclose(lap @ v, vals[1] * v, atol=1e-5)


@pytest.mark.parametrize("norm", ["L1", "L2", "abs-max"])
def test_eigvec_normalizers(norm):
    m = np.random.default_rng(0).normal(size=(7, 3))
    got = tpe.eigvec_normalizer(m, norm)
    np.testing.assert_array_equal(got, jpe.eigvec_normalizer(m, norm))
    measure = {"L1": np.abs(got).sum(0), "L2": np.linalg.norm(got, axis=0),
               "abs-max": np.abs(got).max(0)}[norm]
    np.testing.assert_allclose(measure, 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        tpe.eigvec_normalizer(m, "L3")


@pytest.mark.parametrize("dataset,norm,lap_norm", [
    ("peptides_func", "L2", "sym"), ("peptides_func", "L1", "none"),
    ("voc_superpixels", "abs-max", "sym")])
def test_posenc_stats_are_exact(dataset, norm, lap_norm):
    """The host stats on real-sized graphs, bit for bit against JAX's."""
    maker = {"peptides_func": (js.make_peptides_func, ts.make_peptides_func),
             "voc_superpixels": (js.make_voc_superpixels,
                                 ts.make_voc_superpixels)}[dataset]
    for jg, tg in zip(maker[0](num_graphs=3, seed=4),
                      maker[1](num_graphs=3, seed=4)):
        kw = dict(max_freqs=10, eigvec_norm=norm, laplacian_norm=lap_norm)
        ref = jpe.compute_posenc_stats(jg, **kw)
        got = tpe.compute_posenc_stats(tg, **kw)
        np.testing.assert_array_equal(got.eigvals, ref.eigvals)
        np.testing.assert_array_equal(got.eigvecs, ref.eigvecs)


def _gap_k(evals, k_max=6, gap=1e-2) -> int:
    """The largest k <= k_max with a gap of at least ``gap`` after the
    k-th smallest eigenvalue: the k smallest eigenvectors then span a
    well-defined space."""
    ks = [k for k in range(1, k_max + 1) if evals[k] - evals[k - 1] >= gap]
    assert ks, f"no spectral gap in {evals[:k_max + 1]}"
    return ks[-1]


def _projector(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v @ v.T


def test_batched_eigh_matches_host():
    """The device path (``torch.linalg.eigh`` of padded dense blocks, in
    float64) against the host stats and JAX's ``batched_eigh``: every
    real eigenvalue, and the projector onto the k smallest eigenvectors
    restricted to the real nodes, within 1e-5."""
    graphs = ts.make_peptides_func(num_graphs=3, seed=5)
    n_max = max(g.num_nodes for g in graphs)
    adj = np.zeros((3, n_max, n_max))
    mask = np.zeros((3, n_max), bool)
    for i, g in enumerate(graphs):
        np.add.at(adj[i], (g.edge_index[1], g.edge_index[0]), 1.0)
        mask[i, :g.num_nodes] = True
    evals, evects = tpe.batched_eigh(torch.from_numpy(adj),
                                     torch.from_numpy(mask))
    j_evals, _ = jpe.batched_eigh(jnp.asarray(adj, jnp.float32),
                                  jnp.asarray(mask))
    assert_close(np.sort(evals.numpy(), -1), np.sort(np.asarray(j_evals), -1))
    for i, g in enumerate(graphs):
        n = g.num_nodes
        host = tpe.compute_posenc_stats(g, max_freqs=n)
        # Padding adds eigenvalue-1 pairs with no support on real nodes.
        real = np.abs(evects[i, :n].numpy()).sum(0) > 1e-6
        lam, vec = evals[i].numpy()[real], evects[i, :n].numpy()[:, real]
        np.testing.assert_allclose(lam, host.eigvals[0], atol=1e-5)
        k = _gap_k(lam, gap=1e-4)      # float64 eigh: error ~ 1e-16 / gap
        np.testing.assert_allclose(_projector(vec[:, :k]),
                                   _projector(host.eigvecs[:, :k]),
                                   atol=1e-5)


def test_sparse_and_lobpcg_stats_match_dense():
    """The sparse Laplacian path (scipy shift-invert) and its LOBPCG
    fallback (``torch.lobpcg``) against the dense stats on a 300-node VOC
    graph, both packages: eigenvalues, and projectors at the largest k <= 6
    after a spectral gap, within 1e-5; the threshold routes a graph above
    ``dense_threshold`` to the sparse path."""
    jg = js.make_voc_superpixels(num_graphs=1, seed=3, mean_nodes=300)[0]
    tg = ts.make_voc_superpixels(num_graphs=1, seed=3, mean_nodes=300)[0]
    K = 8
    dense = jpe.compute_posenc_stats(jg, max_freqs=K)
    k = _gap_k(dense.eigvals[0], k_max=K - 1)
    ref_p = _projector(dense.eigvecs[:, :k])
    sparse = tpe.sparse_lap_stats(tg, max_freqs=K)
    j_sparse = jpe.sparse_lap_stats(jg, max_freqs=K)
    routed = tpe.compute_posenc_stats(tg, max_freqs=K, dense_threshold=100)
    for got in (sparse, j_sparse, routed):
        np.testing.assert_allclose(got.eigvals[0], dense.eigvals[0],
                                   atol=1e-5)
        np.testing.assert_allclose(_projector(got.eigvecs[:, :k]), ref_p,
                                   atol=1e-5)
    # LOBPCG on c I - L, as the fallback calls it.
    import scipy.sparse as sp
    n = tg.num_nodes
    lap = sp.csr_matrix(tpe._sym_laplacian(tg, "sym"))
    lam, u = tpe._lobpcg_smallest(lap, n, K, 2.0, 400)
    order = np.argsort(lam)
    np.testing.assert_allclose(lam[order], dense.eigvals[0], atol=1e-5)
    u = tpe.eigvec_normalizer(u[:, order].astype(np.float32))
    np.testing.assert_allclose(_projector(u[:, :k]), ref_p, atol=1e-5)


def _pe_batches(num_graphs=8, batch_size=4, max_freqs=10):
    """The same peptides batch in both packages, eigen stats attached."""
    kw = dict(max_freqs=max_freqs)
    jgs = [jpe.compute_posenc_stats(g, **kw)
           for g in js.make_peptides_func(num_graphs=num_graphs, seed=0)]
    tgs = [tpe.compute_posenc_stats(g, **kw)
           for g in ts.make_peptides_func(num_graphs=num_graphs, seed=0)]
    jbatch = jb.pack_batch(jgs[:batch_size], jb.PadBudget.for_dataset(
        jgs, batch_size))
    tbatch = tb.pack_batch(tgs[:batch_size], tb.PadBudget.for_dataset(
        tgs, batch_size)).to("cpu")
    return jbatch, tbatch


def _encoder_pair(model_type="DeepSet", rho_layers=1, layers=1, **kw):
    args = dict(dim_in=9, dim_emb=16, dim_pe=4, max_freqs=10,
                model_type=model_type, rho_layers=rho_layers,
                sign_inv_layers=layers, **kw)
    return JaxSignNetNodeEncoder(**args), SignNetNodeEncoder(**args)


@pytest.mark.parametrize("model_type,rho_layers,layers,phi_out", [
    ("DeepSet", 1, 1, 4), ("DeepSet", 2, 3, 4), ("MLP", 1, 1, 3)])
def test_signnet_matches_jax(model_type, rho_layers, layers, phi_out):
    """SignNet from carried-over weights: its output and every parameter's
    gradient (of a random projection of the output) within 1e-5 *
    max|ref|, and invariant to the eigenvectors' sign (the carried-over
    tests' check, 1e-5).  MLP's rho takes K * phi_out_dim inputs."""
    jbatch, tbatch = _pe_batches()
    jenc, tenc = _encoder_pair(model_type, rho_layers, layers,
                               phi_out_dim=phi_out)
    params = jax.tree_util.tree_map(
        np.asarray, jenc.init(jax.random.PRNGKey(0), jbatch)["params"])
    tenc.load_state_dict(signnet_params_from_jax(params, rho_layers))
    proj = np.random.default_rng(1).normal(
        size=(tbatch.num_nodes_padded, 16)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jenc.apply({"params": p}, jbatch) * proj)

    ref_out = np.asarray(jenc.apply({"params": params}, jbatch))
    ref_grads = signnet_params_from_jax(jax.grad(jloss)(params), rho_layers)
    out = tenc(tbatch)
    assert out.shape == (tbatch.num_nodes_padded, 16)
    assert_close(out.detach().numpy(), ref_out)
    (out * torch.from_numpy(proj)).sum().backward()
    for name, p in tenc.named_parameters():
        assert_close(p.grad.numpy(), ref_grads[name].numpy())
    flipped = tenc(tbatch.replace(eigvecs=-tbatch.eigvecs))
    np.testing.assert_allclose(flipped.detach().numpy(),
                               out.detach().numpy(), rtol=1e-5, atol=1e-5)
    rho_in = 10 * phi_out if model_type == "MLP" else phi_out
    assert tenc.rho[0].weight.shape[1] == rho_in


def test_signnet_mlp_and_deepset_differ():
    """The MLP variant (concat over K) and DeepSet (masked sum) are
    different functions of the same batch."""
    _, tbatch = _pe_batches()
    gen = torch.Generator().manual_seed(0)
    outs = [SignNetNodeEncoder(9, 16, phi_out_dim=3, model_type=m,
                               generator=gen)(tbatch)
            for m in ("MLP", "DeepSet")]
    assert not torch.allclose(*outs)


def test_torch_init_family():
    """``torch_init``: weights and biases U(+-1/sqrt(fan_in)), as
    nn.Linear's default init; flax's family otherwise (zero biases)."""
    gen = torch.Generator().manual_seed(0)
    enc = SignNetNodeEncoder(9, 16, torch_init=True, generator=gen)
    for layer in [*enc.rho, enc.expand]:
        bound = 1 / np.sqrt(layer.weight.shape[1])
        for t in (layer.weight, layer.bias):
            assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0
    plain = SignNetNodeEncoder(9, 16, generator=gen)
    assert all(float(layer.bias.abs().max()) == 0 for layer in plain.rho)


def test_encoded_model_matches_jax():
    """EncodedModel (trainable SignNet + the GCN MPNN) from carried-over
    weights: logits and every gradient within 1e-5 * max|ref|."""
    pe_kw = dict(dim_in=9, dim_emb=12, dim_pe=4, phi_hidden_dim=8,
                 phi_out_dim=4, eigen_max_freqs=10)
    jcore = JaxMPNN(conv_type="gcn", activation="relu", num_features=12,
                    hidden_channels=16, num_classes=10, num_layers=2)
    jmodel = jax_wrap_with_signnet(jcore, JaxPEConfig(**pe_kw), 9)
    tmodel = wrap_with_signnet(
        MPNN(conv_type="gcn", activation="relu", num_features=12,
             hidden_channels=16, num_classes=10, num_layers=2),
        PEConfig(**pe_kw), 9)
    tx = jax_build_opt("adamW", 0.01, 5e-4)
    batches = [_pe_batches(num_graphs=12, batch_size=4)]
    jbatch, tbatch = batches[0]
    state = jax_init_state(jmodel, tx, jbatch, seed=0)

    def convert(p):
        return encoded_params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), mpnn_params_from_jax, 1)

    tmodel.load_state_dict(convert(state.params))

    def jloss(p):
        logits = jmodel.apply({"params": p}, jbatch, train=False)
        return jnp.sum(logits[:-1] ** 2)

    ref_grads = convert(jax.grad(jloss)(state.params))
    logits = tmodel(tbatch)
    assert_close(logits.detach().numpy(),
                 jmodel.apply({"params": state.params}, jbatch, train=False))
    (logits[:-1] ** 2).sum().backward()
    for name, p in tmodel.named_parameters():
        assert_close(p.grad.numpy(), ref_grads[name].numpy())


def test_frozen_random_transform_matches_jax():
    """attach_posenc(frozen_random=True): node features become dim_emb wide
    and finite, in both packages; with JAX's frozen weights carried over,
    the port's transform gives each graph JAX's features within 1e-5 *
    max|ref|."""
    from graph_hscn_tpu.config.config import DataConfig as JaxDataConfig

    from graph_hscn_tpu_torch.config.config import DataConfig
    pe_kw = dict(dim_in=9, dim_emb=16, dim_pe=4)
    jdm = JaxDataModule.from_config(JaxDataConfig(
        dataset_name="peptides_func", batch_size=4, num_graphs=8))
    jpe.attach_posenc(jdm, JaxPEConfig(**pe_kw), JaxLogger(metric_name="ap"),
                      frozen_random=True, seed=3)
    # The frozen weights attach_posenc drew: the same init on the same
    # example batch.
    ref = JaxDataModule.from_config(JaxDataConfig(
        dataset_name="peptides_func", batch_size=4, num_graphs=8))
    ref.apply_transform(jpe.compute_posenc_stats)
    jenc = JaxSignNetNodeEncoder(dim_in=9, dim_emb=16, dim_pe=4,
                                 torch_init=True)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(3), ref.example_batch())["params"])

    tdm = DataModule.from_config(DataConfig(
        dataset_name="peptides_func", batch_size=4, num_graphs=8))
    tdm.apply_transform(tpe.compute_posenc_stats)
    enc = tpe.build_frozen_signnet(tdm.num_features, PEConfig(**pe_kw), 3)
    enc.load_state_dict(signnet_params_from_jax(params, 1))
    tpe.apply_frozen_signnet(tdm, enc, "cpu")
    assert tdm.num_features == jdm.num_features == 16
    for tg, jg in zip(tdm.graphs, jdm.graphs, strict=True):
        assert tg.x.shape == jg.x.shape == (tg.num_nodes, 16)
        assert np.isfinite(tg.x).all()
        assert_close(tg.x, jg.x)
    # attach_posenc itself, with the port's own frozen draw.
    tdm2 = DataModule.from_config(DataConfig(
        dataset_name="peptides_func", batch_size=4, num_graphs=8))
    tpe.attach_posenc(tdm2, PEConfig(**pe_kw), Logger(metric_name="ap"),
                      frozen_random=True, seed=3)
    assert tdm2.num_features == 16
    assert all(g.x.shape[1] == 16 and np.isfinite(g.x).all()
               for g in tdm2.graphs)


def _pe_raw(frozen: bool):
    return {
        "data": {"dataset_name": "peptides_func", "batch_size": 8,
                 "num_graphs": 16},
        "mp": {"conv_type": "gcn", "activation": "relu",
               "hidden_channels": 16, "num_layers": 2, "dropout": 0.0},
        "optim": {"optim_type": "adamW", "lr": 0.005,
                  "weight_decay": 5.0e-4},
        "pe": {"use": True, "dim_in": 16, "dim_emb": 16, "dim_pe": 4,
               "eig_max_freqs": 8, "phi_hidden_dim": 8, "phi_out_dim": 4},
        "training": {"model_type": "gcn", "use_wandb": False,
                     "loss_fn": "cross_entropy", "metric": "ap",
                     "max_epochs": 3, "eval_period": 2, "patience": 50,
                     "min_delta": 0.0},
        "compat": {"frozen_random_signnet": frozen},
    }


@pytest.mark.parametrize("frozen", [True, False])
def test_pe_runs_end_to_end(frozen, tmp_path):
    """The PE config of tests/test_pe_e2e.py through run_experiment in
    both packages: finite losses of the same epochs; the trainable SignNet
    lowers the train loss; the model is the EncodedModel only there."""
    jres = jax_run_experiment(jax_parse_config(_pe_raw(frozen)),
                              log_file=tmp_path / "j.log")
    tres = run_experiment(parse_config(_pe_raw(frozen)), device="cpu",
                          log_file=tmp_path / "t.log")
    for res in (jres, tres):
        losses = [h["train_loss"] for h in res.history]
        assert len(losses) == 3 and np.isfinite(losses).all()
        if not frozen:
            assert losses[-1] < losses[0]
    assert (type(tres.model).__name__ == "EncodedModel") == (not frozen)
