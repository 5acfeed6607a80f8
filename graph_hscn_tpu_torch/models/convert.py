"""Carry weights from the JAX package's models to the port's.

A flax ``MPNN`` keeps ``{'params': {'GCNConv_i': {'kernel' [in, out],
'bias' [out]}}}``; the port's ``MPNN`` keeps ``convs.i.weight`` [out, in]
and ``convs.i.bias`` (a GIN conv its MLP's, a LayerNorm its scale and
bias).  A GAT ``MPNN`` keeps ``GATConv_i`` with
``kernel_src`` [in, H*C], ``att_src`` and ``att_dst`` [1, H, C] and
``bias``; the port keeps ``convs.i.weight`` [H*C, in], ``att_src``,
``att_dst`` and ``bias``.  A flax ``FusedDenseGCN`` keeps ``kernel_i`` [in,
out] and ``bias_i``, and so does the port's.  A flax ``GatedGCNNet``
keeps numbered ``Dense_k`` and ``GatedGCNConv_i`` modules, which
:func:`gatedgcn_params_from_jax` names; a flax ``SCN`` and ``HSCN`` keep
theirs numbered by class in the order of creation, which
:func:`scn_params_from_jax` and :func:`hscn_params_from_jax` follow; a
flax ``GPSModel`` likewise (:func:`gps_params_from_jax`), and a flax
``SignNetNodeEncoder`` its ``_GINLayer_i`` and ``Dense_j``
(:func:`signnet_params_from_jax`; an ``EncodedModel`` its ``encoder`` and
``core``, :func:`encoded_params_from_jax`).  With
the weights carried across, both packages compute the same function, which
is how the tests hold one against the other.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def mpnn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax MPNN params (the ``'params'`` tree or the whole variables dict,
    leaves convertible with ``np.asarray``) -> the port MPNN's
    ``state_dict``: ``GCNConv_i``/``GATConv_i``/``GINConv_i`` are
    ``convs.i`` (a GIN conv's ``Dense_0``/``Dense_1`` its ``mlp.layers.0``
    and ``.1``), ``LayerNorm_i`` (``use_layer_norm``) ``norms.i``."""
    params = params.get("params", params)
    state = {}
    for name, leaves in params.items():
        m = re.fullmatch(r"(GCN|GAT|GIN|Layer)(Conv|Norm)_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r} (MPNN params "
                             "hold GCNConv_i, GATConv_i, GINConv_i and "
                             "LayerNorm_i only)")
        i = int(m.group(3))
        if m.group(1) == "Layer":
            state.update(_leaves(f"norms.{i}.", leaves, _LN))
            continue
        prefix = f"convs.{i}."
        if m.group(1) == "GIN":
            if set(leaves) != {"Dense_0", "Dense_1"}:
                raise ValueError(f"unexpected flax params {sorted(leaves)} "
                                 f"in {name}")
            for k in range(2):
                state.update(_dense(f"{prefix}mlp.layers.{k}.",
                                    leaves[f"Dense_{k}"]))
            continue
        for leaf, value in leaves.items():
            value = np.asarray(value, dtype=np.float32)
            if leaf in ("kernel", "kernel_src"):
                state[prefix + "weight"] = torch.from_numpy(value.T.copy())
            elif leaf in ("bias", "att_src", "att_dst"):
                state[prefix + leaf] = torch.from_numpy(value.copy())
            else:
                raise ValueError(f"unexpected flax param {name}/{leaf}")
    return state


def _leaves(prefix: str, leaves, names: dict) -> dict[str, torch.Tensor]:
    """A flax module's leaves as the port's ``prefix + names[leaf]``;
    kernels [in, out] transposed to weights [out, in], other leaves as
    they are."""
    if set(leaves) != set(names):
        raise ValueError(f"unexpected flax params {sorted(leaves)} for "
                         f"{prefix!r} (want {sorted(names)})")
    state = {}
    for leaf, value in leaves.items():
        value = np.asarray(value, dtype=np.float32)
        if leaf.startswith("kernel"):
            value = value.T
        state[prefix + names[leaf]] = torch.from_numpy(value.copy())
    return state


def _dense(prefix: str, leaves) -> dict[str, torch.Tensor]:
    """A flax Dense's kernel [in, out] and bias as the port's ``Dense``
    weight [out, in] and bias."""
    return _leaves(prefix, leaves, {"kernel": "weight", "bias": "bias"})


_LN = {"scale": "scale", "bias": "bias"}


def gated_gcn_conv_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax GatedGCNConv params -> the port GatedGCNConv's ``state_dict``:
    ``Dense_0`` .. ``Dense_4`` are A .. E, ``LayerNorm_0`` is x's
    (``norm_x``) and ``LayerNorm_1`` e's (``norm_e``); with
    ``norm="none"`` there are no LayerNorms."""
    state = {}
    for name, leaves in params.items():
        if (m := re.fullmatch(r"Dense_([0-4])", name)) is not None:
            state.update(_dense("ABCDE"[int(m.group(1))] + ".", leaves))
        elif name in ("LayerNorm_0", "LayerNorm_1"):
            norm = "norm_x." if name == "LayerNorm_0" else "norm_e."
            for leaf in ("scale", "bias"):
                state[norm + leaf] = torch.from_numpy(np.asarray(
                    leaves[leaf], dtype=np.float32).copy())
        else:
            raise ValueError(f"unexpected flax module {name!r} in a "
                             "GatedGCNConv")
    return state


def gatedgcn_params_from_jax(params, edge_encoder: bool
                             ) -> dict[str, torch.Tensor]:
    """flax GatedGCNNet params -> the port GatedGCNNet's ``state_dict``.

    flax numbers the net's Dense layers in the order they are created:
    ``Dense_0`` the node encoder, ``Dense_1`` the edge encoder only when
    the batch has ``edge_feat`` (``edge_encoder``), then the head's one
    (readout "none") or two (mean readout) layers; ``GatedGCNConv_i`` is
    ``layers.i``."""
    params = params.get("params", params)
    dense = sorted((int(m.group(1)), name) for name in params
                   if (m := re.fullmatch(r"Dense_(\d+)", name)))
    names = ["encoder"] + (["edge_encoder"] if edge_encoder else [])
    head = len(dense) - len(names)
    if head not in (1, 2):
        raise ValueError(f"{len(dense)} flax Dense layers do not fit a "
                         "GatedGCNNet head of 1 or 2 "
                         + ("with" if edge_encoder else "without")
                         + " an edge encoder")
    names += ["head"] if head == 1 else ["pool_dense", "head"]
    state = {}
    for (_, flax_name), name in zip(dense, names):
        state.update(_dense(name + ".", params[flax_name]))
    for name, leaves in params.items():
        if re.fullmatch(r"Dense_\d+", name):
            continue
        m = re.fullmatch(r"GatedGCNConv_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r} in a "
                             "GatedGCNNet")
        state.update({f"layers.{int(m.group(1))}.{k}": v for k, v in
                      gated_gcn_conv_params_from_jax(leaves).items()})
    return state


def _mha(prefix: str, params) -> dict[str, torch.Tensor]:
    """flax GraphMHA params -> the port GraphMHA's: ``query``/``key``/
    ``value`` kernels [H, nh, hd] and biases [nh, hd], flattened to a
    Dense's [nh*hd, H] weight and [nh*hd] bias; ``out``'s kernel [nh, hd,
    H] to a weight [H, nh*hd]."""
    if set(params) != {"query", "key", "value", "out"}:
        raise ValueError(f"unexpected flax GraphMHA params {sorted(params)}")
    state = {}
    for name, leaves in params.items():
        kernel = np.asarray(leaves["kernel"], np.float32)
        if name == "out":
            kernel = kernel.reshape(-1, kernel.shape[-1])
        else:
            kernel = kernel.reshape(kernel.shape[0], -1)
        state.update(_dense(f"{prefix}{name}.", {
            "kernel": kernel,
            "bias": np.asarray(leaves["bias"], np.float32).reshape(-1)}))
    return state


_GPS_LAYER = {"LayerNorm_0": "norm_local", "LayerNorm_1": "norm_global",
              "LayerNorm_2": "norm_ffn", "Dense_0": "ffn0", "Dense_1": "ffn1",
              "GCNConv_0": "local", "GatedGCNConv_0": "local",
              "GraphMHA_0": "attn"}


def gps_layer_params_from_jax(params, prefix: str = ""
                              ) -> dict[str, torch.Tensor]:
    """flax GPSLayer params -> the port GPSLayer's ``state_dict`` (names
    after ``prefix``): ``LayerNorm_0/1/2`` the local, global and FFN norms,
    ``GCNConv_0`` or ``GatedGCNConv_0`` the local module, ``GraphMHA_0``
    the attention, ``Dense_0/1`` the FFN.  A subtree of these modules maps
    alone (a GraphMHA's: ``{"GraphMHA_0": ...}``)."""
    params = params.get("params", params)
    state = {}
    for name, leaves in params.items():
        if name not in _GPS_LAYER:
            raise ValueError(f"unexpected flax module {name!r} in a "
                             "GPSLayer")
        sub = prefix + _GPS_LAYER[name] + "."
        if name.startswith("LayerNorm_"):
            state.update(_leaves(sub, leaves, _LN))
        elif name.startswith("Dense_"):
            state.update(_dense(sub, leaves))
        elif name == "GCNConv_0":
            state.update(_leaves(sub, leaves,
                                 {"kernel": "weight", "bias": "bias"}))
        elif name == "GatedGCNConv_0":
            state.update({sub + k: v for k, v in
                          gated_gcn_conv_params_from_jax(leaves).items()})
        else:
            state.update(_mha(sub, leaves))
    return state


def gps_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax GPSModel params -> the port GPSModel's ``state_dict``.

    flax numbers the model's Dense layers in the order they are created:
    ``Dense_0`` the input encoder, ``Dense_1`` the edge encoder with the
    "gatedgcn" local module, then the head (``Dense_1`` with "gcn",
    ``Dense_2`` with "gatedgcn"); ``LayerNorm_0`` is the final norm and
    ``GPSLayer_i`` is ``layers.i`` (:func:`gps_layer_params_from_jax`)."""
    params = params.get("params", params)
    dense = sorted(int(m.group(1)) for name in params
                   if (m := re.fullmatch(r"Dense_(\d+)", name)))
    if dense not in ([0, 1], [0, 1, 2]):
        raise ValueError(f"flax Dense layers {dense} do not fit a GPSModel")
    names = (["encoder", "head"] if len(dense) == 2
             else ["encoder", "edge_encoder", "head"])
    state = {}
    for i, name in zip(dense, names):
        state.update(_dense(name + ".", params[f"Dense_{i}"]))
    for name, leaves in params.items():
        if re.fullmatch(r"Dense_\d+", name):
            continue
        if name == "LayerNorm_0":
            state.update(_leaves("norm.", leaves, _LN))
        elif (m := re.fullmatch(r"GPSLayer_(\d+)", name)) is not None:
            state.update(gps_layer_params_from_jax(
                leaves, prefix=f"layers.{int(m.group(1))}."))
        else:
            raise ValueError(f"unexpected flax module {name!r} in a "
                             "GPSModel")
    return state


def fused_gcn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax FusedDenseGCN params (``kernel_i`` [in, out], ``bias_i``; the
    ``'params'`` tree or the whole variables dict) -> the port
    FusedDenseGCN's ``state_dict`` (the same names and layout)."""
    params = params.get("params", params)
    state = {}
    for name, leaf in params.items():
        if re.fullmatch(r"(kernel|bias)_\d+", name) is None:
            raise ValueError(f"unexpected flax param {name!r} (FusedDenseGCN "
                             "holds kernel_i and bias_i only)")
        state[name] = torch.from_numpy(
            np.asarray(leaf, dtype=np.float32).copy())
    return state


_GAT = {"kernel_src": "weight", "att_src": "att_src", "att_dst": "att_dst",
        "bias": "bias"}


def scn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax SCN params (no MLP, as ``build_scn`` makes it) -> the port
    SCN's ``state_dict``: ``GraphConv_i`` (``kernel_rel``, ``kernel_root``,
    ``bias``) is ``convs.i``, ``Dense_0`` is ``cluster``."""
    params = params.get("params", params)
    state = {}
    for name, leaves in params.items():
        if (m := re.fullmatch(r"GraphConv_(\d+)", name)) is not None:
            state.update(_leaves(
                f"convs.{m.group(1)}.", leaves,
                {"kernel_rel": "weight_rel", "kernel_root": "weight_root",
                 "bias": "bias"}))
        elif name == "Dense_0":
            state.update(_dense("cluster.", leaves))
        else:
            raise ValueError(f"unexpected flax module {name!r} in an SCN "
                             "(GraphConv_i and Dense_0)")
    return state


def hscn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax HSCN params -> the port HSCN's ``state_dict``.

    flax numbers modules by one counter a class, in the order the layer
    loop creates them: the ll relation (``GCNConv_l``, or a ``GATConv``),
    the lv relation (``GATConv``), the vv relation (``DenseGCN_l`` or
    ``DenseGAT_l``), ``VLDense_l`` (virtual feedback), then ``Dense_0``
    and ``Dense_1`` for the head.  With a GAT ll relation it shares the
    ``GATConv`` counter with lv: ``GATConv_{2l}`` is ll layer l and
    ``GATConv_{2l+1}`` lv layer l; otherwise ``GATConv_l`` is lv layer
    l.  lv's GATConv is the one with a ``kernel_dst`` (bipartite)."""
    params = params.get("params", params)
    ll_gat = any(name.startswith("GATConv_") and "kernel_dst" not in leaves
                 for name, leaves in params.items())
    state = {}
    for name, leaves in params.items():
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r} in an HSCN")
        kind, i = m.group(1), int(m.group(2))
        if kind == "GCNConv":
            state.update(_leaves(f"ll.{i}.", leaves,
                                 {"kernel": "weight", "bias": "bias"}))
        elif kind == "GATConv":
            rel = "lv" if "kernel_dst" in leaves else "ll"
            names = dict(_GAT)
            if rel == "lv":
                names["kernel_dst"] = "weight_dst"
            layer = i // 2 if ll_gat else i
            state.update(_leaves(f"{rel}.{layer}.", leaves, names))
        elif kind == "DenseGCN":
            state.update(_leaves(f"vv.{i}.", leaves,
                                 {"kernel": "weight", "bias": "bias"}))
        elif kind == "DenseGAT":
            state.update(_leaves(f"vv.{i}.", leaves, _GAT))
        elif kind == "VLDense":
            state.update(_dense(f"vl.{i}.", leaves))
        elif kind == "Dense" and i in (0, 1):
            state.update(_dense(("pool_dense.", "head.")[i], leaves))
        else:
            raise ValueError(f"unexpected flax module {name!r} in an HSCN")
    return state



def signnet_params_from_jax(params, rho_layers: int,
                            expand_x: bool = True) -> dict[str, torch.Tensor]:
    """flax SignNetNodeEncoder params -> the port encoder's
    ``state_dict``: ``_GINLayer_i/Dense_j`` is ``phi.i.layers.j``; the
    encoder's own ``Dense_j``, numbered in the order they are made, are
    rho's ``rho_layers`` layers (its hidden ones, then the PE layer) and,
    with ``expand_x``, then ``expand``."""
    params = params.get("params", params)
    want = rho_layers + int(expand_x)
    state = {}
    for name, leaves in params.items():
        if (m := re.fullmatch(r"_GINLayer_(\d+)", name)) is not None:
            for sub, dense in leaves.items():
                j = re.fullmatch(r"Dense_(\d+)", sub)
                if j is None:
                    raise ValueError(f"unexpected flax module {name}/{sub}")
                state.update(_dense(
                    f"phi.{m.group(1)}.layers.{j.group(1)}.", dense))
        elif (m := re.fullmatch(r"Dense_(\d+)", name)) is not None:
            j = int(m.group(1))
            if j >= want:
                raise ValueError(f"{name}: the encoder has {want} Dense "
                                 "layers of its own")
            state.update(_dense("expand." if j == rho_layers
                                else f"rho.{j}.", leaves))
        else:
            raise ValueError(f"unexpected flax module {name!r} in a "
                             "SignNetNodeEncoder")
    return state


def encoded_params_from_jax(params, core_from_jax, rho_layers: int,
                            expand_x: bool = True
                            ) -> dict[str, torch.Tensor]:
    """flax EncodedModel params (``encoder``, ``core``) -> the port
    EncodedModel's ``state_dict``: ``encoder.`` + the SignNet's names
    (:func:`signnet_params_from_jax`), ``core.`` + ``core_from_jax(the core
    params)`` (e.g. :func:`mpnn_params_from_jax`)."""
    params = params.get("params", params)
    state = {f"encoder.{k}": v for k, v in signnet_params_from_jax(
        params["encoder"], rho_layers, expand_x).items()}
    state.update({f"core.{k}": v
                  for k, v in core_from_jax(params["core"]).items()})
    return state


def _sharded_layers(params, names: dict) -> dict[str, torch.Tensor]:
    """A JAX sharded stack's list of per-layer dicts -> ``layers.i.`` +
    ``names[leaf]``; kernels [in, out] transposed to weights [out, in]."""
    state = {}
    for i, layer in enumerate(params):
        if set(layer) != set(names):
            raise ValueError(f"unexpected sharded params {sorted(layer)} in "
                             f"layer {i} (want {sorted(names)})")
        for leaf, value in layer.items():
            value = np.asarray(value, dtype=np.float32)
            if leaf in ("kernel", "w1", "w2"):
                value = value.T
            state[f"layers.{i}.{names[leaf]}"] = torch.from_numpy(
                value.copy())
    return state


def sharded_gcn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_gcn_params``' list of ``{"kernel", "bias"}`` -> the
    port ShardedGCN's ``state_dict`` (``layers.i.weight``, ``.bias``)."""
    return _sharded_layers(params, {"kernel": "weight", "bias": "bias"})


def sharded_gin_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_gin_params``' list of ``{"w1", "b1", "w2", "b2"}``
    -> the port ShardedGIN's ``state_dict`` (``layers.i.lin1`` and
    ``.lin2``)."""
    return _sharded_layers(params, {
        "w1": "lin1.weight", "b1": "lin1.bias", "w2": "lin2.weight",
        "b2": "lin2.bias"})


def sharded_gat_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_gat_params``' list of ``{"kernel" [in, H*C],
    "att_src", "att_dst" [H, C], "bias"}`` -> the port ShardedGAT's
    ``state_dict``."""
    return _sharded_layers(params, {
        "kernel": "weight", "att_src": "att_src", "att_dst": "att_dst",
        "bias": "bias"})


_ATTN = {"wq": "q.weight", "wk": "k.weight", "wv": "v.weight",
         "wo": "o.weight", "bq": "q.bias", "bk": "k.bias", "bv": "v.bias",
         "bo": "o.bias"}


def _tree(params, prefix: str = "", rename: dict | None = None
          ) -> dict[str, torch.Tensor]:
    """A JAX sharded model's nested dicts and lists -> the port's dotted
    names: list items by index, keys through ``rename`` (to "" to drop a
    level), kernels [in, out] (``kernel``, ``kernel_*``) transposed to
    weights [out, in] (``weight``, ``weight_*``), the attention's
    ``wq``/``wk``/``wv`` [H, heads, hd] and ``wo`` [heads, hd, H] as the
    ``q``/``k``/``v``/``o`` weights [out, in], their biases flattened."""
    rename = rename or {}
    items = (enumerate(params) if isinstance(params, (list, tuple))
             else params.items())
    state = {}
    for key, value in items:
        key = str(key)
        if isinstance(value, (dict, list, tuple)):
            name = rename.get(key, key)
            state.update(_tree(value, f"{prefix}{name}." if name else prefix,
                               rename))
            continue
        value = np.asarray(value, dtype=np.float32)
        if key in ("wq", "wk", "wv"):
            value = value.reshape(value.shape[0], -1).T
        elif key == "wo":
            value = value.reshape(-1, value.shape[-1]).T
        elif key in _ATTN:
            value = value.reshape(-1)
        elif key.startswith("kernel"):
            key, value = "weight" + key[len("kernel"):], value.T
        state[prefix + _ATTN.get(key, key)] = torch.from_numpy(value.copy())
    return state


def sharded_gatedgcn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_gatedgcn_params``' tree (``enc_x``, ``enc_e``,
    ``layers`` of A..E, ``ln_x``, ``ln_e``, ``head``) -> the port
    ShardedGatedGCN's ``state_dict`` (the same names)."""
    return _tree(params)


def sharded_gps_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_gps_params``' tree -> the port ShardedGPS's
    ``state_dict``: ``in`` is ``inp``, the attention's ``wq`` .. ``bo``
    its ``q``/``k``/``v``/``o`` layers, the rest by name."""
    return _tree(params, rename={"in": "inp"})


def sharded_scn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_scn_params``' tree (``layers`` of ``kernel_rel``,
    ``kernel_root``, ``bias``; ``head``) -> the port ShardedSCN's
    ``state_dict`` (``weight_rel``, ``weight_root``)."""
    return _tree(params)


def sharded_hscn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """``init_sharded_hscn_params``' tree (``layers`` of ``ll``, ``lv``,
    ``vv`` and ``vl``; ``head`` of ``h1``, ``h2``) -> the port
    ShardedHSCN's ``state_dict`` (the head's layers at the top)."""
    return _tree(params, rename={"head": ""})
