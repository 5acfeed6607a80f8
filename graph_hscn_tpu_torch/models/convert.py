"""Carry weights from the JAX package's models to the port's.

A flax ``MPNN`` keeps ``{'params': {'GCNConv_i': {'kernel' [in, out],
'bias' [out]}}}``; the port's ``MPNN`` keeps ``convs.i.weight`` [out, in]
and ``convs.i.bias``.  A GAT ``MPNN`` keeps ``GATConv_i`` with
``kernel_src`` [in, H*C], ``att_src`` and ``att_dst`` [1, H, C] and
``bias``; the port keeps ``convs.i.weight`` [H*C, in], ``att_src``,
``att_dst`` and ``bias``.  A flax ``FusedDenseGCN`` keeps ``kernel_i`` [in,
out] and ``bias_i``, and so does the port's.  With the weights carried
across, both packages compute the same function, which is how the tests
hold one against the other.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def mpnn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """flax MPNN params (the ``'params'`` tree or the whole variables dict,
    leaves convertible with ``np.asarray``) -> the port MPNN's
    ``state_dict``."""
    params = params.get("params", params)
    state = {}
    for name, leaves in params.items():
        m = re.fullmatch(r"(GCN|GAT)Conv_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r} (MPNN params "
                             "hold GCNConv_i or GATConv_i only)")
        prefix = f"convs.{int(m.group(2))}."
        for leaf, value in leaves.items():
            value = np.asarray(value, dtype=np.float32)
            if leaf in ("kernel", "kernel_src"):
                state[prefix + "weight"] = torch.from_numpy(value.T.copy())
            elif leaf in ("bias", "att_src", "att_dst"):
                state[prefix + leaf] = torch.from_numpy(value.copy())
            else:
                raise ValueError(f"unexpected flax param {name}/{leaf}")
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
