"""Laplacian positional-encoding statistics: the counterpart of
``graph_hscn_tpu/transform/posenc.py`` (the reference's transform/posenc.py).

Per graph: symmetric-normalized graph Laplacian -> eigendecomposition ->
keep the ``max_freqs`` smallest eigenpairs -> normalize the eigenvectors
(L1/L2/abs-max, posenc.py:85-107) -> NaN-pad when N < max_freqs
(posenc.py:67-78).

- On the host, per graph: a dense numpy ``eigh`` (the same arithmetic as
  the JAX package's, so the stats agree bit for bit), or for graphs past
  ``dense_threshold`` nodes scipy's shift-invert ``eigsh`` on the sparse
  Laplacian, with ``torch.lobpcg`` on the run's device as its fallback;
  one-time preprocessing cached on the graphs.
- On the device, batched: :func:`batched_eigh`, ``torch.linalg.eigh`` of
  dense per-graph blocks.

:func:`attach_posenc` then applies SignNet.  With ``frozen_random=True``
(the reference's quirk #6, train.py:29-51) a randomly initialized, frozen
SignNet is mapped once over the dataset, on the run's device with no
gradient, and its output becomes the node features.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_hscn_tpu_torch.data.batching import GraphData, iter_batches


def _sym_laplacian(g: GraphData, norm: str | None = "sym") -> np.ndarray:
    n = g.num_nodes
    a = np.zeros((n, n), dtype=np.float64)
    src, dst = g.edge_index
    np.add.at(a, (dst, src), 1.0)
    deg = a.sum(axis=1)
    if norm is None:
        return np.diag(deg) - a
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(deg)
    dinv[~np.isfinite(dinv)] = 0.0
    return np.eye(n) - dinv[:, None] * a * dinv[None, :]


def eigvec_normalizer(evects: np.ndarray, normalization: str = "L2",
                      eps: float = 1e-12) -> np.ndarray:
    """Column-wise normalization (reference posenc.py:85-107)."""
    if normalization == "L1":
        denom = np.abs(evects).sum(axis=0, keepdims=True)
    elif normalization == "L2":
        denom = np.linalg.norm(evects, axis=0, keepdims=True)
    elif normalization == "abs-max":
        denom = np.abs(evects).max(axis=0, keepdims=True)
    else:
        raise ValueError(f"Unsupported normalization `{normalization}`")
    return evects / np.maximum(denom, eps)


def _padded(g: GraphData, evals: np.ndarray, evects: np.ndarray,
            max_freqs: int) -> GraphData:
    """``g`` with eigvals [N, K] (each row the spectrum) and eigvecs [N, K],
    NaN past the k pairs given."""
    n, k = g.num_nodes, len(evals)
    eigvecs = np.full((n, max_freqs), np.nan, dtype=np.float32)
    eigvecs[:, :k] = evects
    eigvals = np.full((max_freqs,), np.nan, dtype=np.float32)
    eigvals[:k] = evals
    eigvals = np.broadcast_to(eigvals, (n, max_freqs)).copy()
    return g.replace(eigvals=eigvals, eigvecs=eigvecs)


def compute_posenc_stats(g: GraphData, max_freqs: int = 10,
                         eigvec_norm: str = "L2",
                         laplacian_norm: str = "sym",
                         dense_threshold: int = 2048,
                         device: torch.device | str = "cpu") -> GraphData:
    """Attach eigvals [N, K] / eigvecs [N, K] to one graph (NaN-padded when
    N < K, like reference posenc.py:67-78).  Graphs above
    ``dense_threshold`` nodes take :func:`sparse_lap_stats` (its LOBPCG
    fallback on ``device``): the dense ``eigh`` is O(N^2) memory and
    O(N^3) time."""
    n = g.num_nodes
    if n > dense_threshold and n >= 8 * max_freqs:
        return sparse_lap_stats(g, max_freqs=max_freqs,
                                eigvec_norm=eigvec_norm,
                                laplacian_norm=laplacian_norm, device=device)
    norm = None if laplacian_norm.lower() == "none" else laplacian_norm
    lap = _sym_laplacian(g, norm)
    evals, evects = np.linalg.eigh(lap)
    idx = np.argsort(evals)[:max_freqs]
    evals = np.clip(np.real(evals[idx]), 0.0, None)
    evects = np.real(evects[:, idx]).astype(np.float32)
    evects = eigvec_normalizer(evects, eigvec_norm)
    return _padded(g, evals, evects, max_freqs)


def sparse_lap_stats(g: GraphData, max_freqs: int = 10,
                     eigvec_norm: str = "L2", laplacian_norm: str = "sym",
                     iters: int = 200,
                     device: torch.device | str = "cpu") -> GraphData:
    """Sparse-Laplacian PE for large graphs: no N x N matrix exists.

    ARPACK shift-invert (scipy ``eigsh``, sigma just below 0) on the CSR
    Laplacian resolves its tightly clustered smallest eigenpairs in a few
    Lanczos iterations.  If ARPACK does not converge, LOBPCG on ``device``
    (:func:`_lobpcg_smallest`).  Eigenvalue order and normalization match
    the dense path; within a degenerate eigenspace any orthobasis is valid
    (as LAPACK's choice is arbitrary)."""
    import scipy.sparse as sp

    n = g.num_nodes
    k = min(max_freqs, n)
    src, dst = (np.asarray(a, np.int64) for a in g.edge_index)
    deg = np.bincount(dst, minlength=n).astype(np.float64)
    if laplacian_norm.lower() != "none":
        with np.errstate(divide="ignore"):
            dinv = 1.0 / np.sqrt(deg)
        dinv[~np.isfinite(dinv)] = 0.0
        w = dinv[src] * dinv[dst]
        diag = np.ones(n)                        # L = I - Anorm
        c = 2.0
    else:
        w = np.ones(len(src))
        diag = deg                               # L = D - A
        c = float(2.0 * max(deg.max(), 1.0))
    lap = (sp.csr_matrix((diag, (np.arange(n), np.arange(n))), shape=(n, n))
           - sp.csr_matrix((w, (dst, src)), shape=(n, n)))
    try:
        from scipy.sparse.linalg import ArpackError, ArpackNoConvergence
        from scipy.sparse.linalg import eigsh
        # A small negative shift: L is PSD with lambda_0 = 0, so L - sigma I
        # is positive definite and its factorization well-posed.
        evals, u = eigsh(lap.tocsc(), k=k, sigma=-1e-2, which="LM")
    except (ArpackError, ArpackNoConvergence):
        evals, u = _lobpcg_smallest(lap, n, k, c, iters, device)
    evals = np.clip(np.real(evals), 0.0, None)
    order = np.argsort(evals)[:k]
    evects = eigvec_normalizer(np.asarray(u, np.float32)[:, order],
                               eigvec_norm)
    return _padded(g, evals[order], evects, max_freqs)


def _lobpcg_smallest(lap, n: int, k: int, c: float, iters: int,
                     device: torch.device | str = "cpu"):
    """LOBPCG on ``device``: the k largest eigenpairs of the PSD operator
    c I - L (a sparse matrix there), returned as L's k smallest: (eigenvalues
    [k] float64, eigenvectors [n, k])."""
    import scipy.sparse as sp

    coo = (c * sp.identity(n, format="csr") - lap).tocoo()
    op = torch.sparse_coo_tensor(
        np.stack([coo.row, coo.col]), coo.data, (n, n),
        dtype=torch.float64, device=device).coalesce()
    gen = torch.Generator(device=device).manual_seed(0)
    x0 = torch.randn(n, k, generator=gen, dtype=torch.float64, device=device)
    theta, u = torch.lobpcg(op, k=k, X=x0, niter=iters, largest=True)
    return c - theta.cpu().numpy(), u.cpu().numpy()


def batched_eigh(adj_dense: torch.Tensor, node_mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device path: eigendecomposition of the sym-normalized
    Laplacians of dense per-graph blocks [G, n_max, n_max].  Padding rows
    and columns become an identity block, so their spurious eigenpairs have
    eigenvalue 1 and no support on real nodes; callers mask by n_node when
    they take the k smallest.  Returns (evals [G, n_max], evects [G, n_max,
    n_max])."""
    m = node_mask.to(adj_dense.dtype)
    a = adj_dense * m[:, :, None] * m[:, None, :]
    deg = a.sum(-1)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
    eye = torch.eye(adj_dense.shape[-1], dtype=adj_dense.dtype,
                    device=adj_dense.device)
    lap = eye - a * dinv[:, :, None] * dinv[:, None, :]
    return torch.linalg.eigh(lap)


def build_frozen_signnet(num_features: int, pe_cfg, seed: int):
    """The frozen-random encoder of quirk #6: torch's ``nn.Linear`` init
    family (the reference never trains these weights, so the init
    distribution is the model), drawn from a generator seeded with
    ``seed``."""
    from graph_hscn_tpu_torch.models.signnet import SignNetNodeEncoder
    return SignNetNodeEncoder(
        dim_in=num_features, dim_emb=pe_cfg.dim_emb, dim_pe=pe_cfg.dim_pe,
        phi_hidden_dim=pe_cfg.phi_hidden_dim, phi_out_dim=pe_cfg.phi_out_dim,
        sign_inv_layers=pe_cfg.layers, rho_layers=pe_cfg.post_layers,
        max_freqs=pe_cfg.eigen_max_freqs, model_type=pe_cfg.model,
        torch_init=True, generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def apply_frozen_signnet(dm, encoder, device: torch.device | str) -> None:
    """Map ``encoder`` once over ``dm.graphs`` on ``device`` and make its
    output each graph's node features (``dm.num_features`` becomes its
    width)."""
    encoder = encoder.to(device).eval()
    new_graphs = []
    for batch in iter_batches(dm.graphs, dm.batch_size, dm.budget,
                              shuffle=False):
        new_x = encoder(batch.to(device)).cpu().numpy()
        ng, nm = batch.node_graph, batch.node_mask
        for gi in range(int(batch.graph_mask.sum())):
            g = dm.graphs[len(new_graphs)]
            new_graphs.append(g.replace(x=new_x[nm & (ng == gi)]))
    if len(new_graphs) != len(dm.graphs):
        raise RuntimeError(f"{len(new_graphs)} transformed graphs for "
                           f"{len(dm.graphs)}")
    dm.graphs = new_graphs
    dm.num_features = encoder.dim_emb


def attach_posenc(dm, pe_cfg, logger, frozen_random: bool = True,
                  seed: int = 0, device: torch.device | str = "cpu") -> None:
    """Eigen stats for every graph, then SignNet.

    frozen_random=True (reference quirk #6): a random SignNet runs once
    with no gradient as a dataset transform on ``device``; node features
    become [Linear(x) | PE], ``dim_emb`` wide.
    frozen_random=False: the eigen fields stay on the batches for the
    trainable SignNet inside the model (``models/encoded.py``).
    """
    logger.info("Precomputing Laplacian eigen stats for all graphs...")
    dm.apply_transform(lambda g: compute_posenc_stats(
        g, max_freqs=pe_cfg.eigen_max_freqs, eigvec_norm=pe_cfg.eigvec_norm,
        laplacian_norm=pe_cfg.eigen_laplacian_norm, device=device))
    if not frozen_random:
        logger.info("PE stats attached; SignNet trains end-to-end.")
        return
    logger.info("Applying frozen random SignNet transform "
                "(reference train.py:29-51 semantics)...")
    apply_frozen_signnet(dm, build_frozen_signnet(dm.num_features, pe_cfg,
                                                  seed), device)
    logger.info(f"PE transform done; node feature dim -> {pe_cfg.dim_emb}")
