"""Carry weights from the JAX package's models to the port's.

A flax ``MPNN`` keeps ``{'params': {'GCNConv_i': {'kernel' [in, out],
'bias' [out]}}}``; the port's ``MPNN`` keeps ``convs.i.weight`` [out, in]
and ``convs.i.bias``.  With the weights carried across, both packages
compute the same function, which is how the tests hold one against the
other.
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
        m = re.fullmatch(r"GCNConv_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r} (GCN MPNN "
                             "params hold GCNConv_i only)")
        i = int(m.group(1))
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        state[f"convs.{i}.weight"] = torch.from_numpy(kernel.T.copy())
        if "bias" in leaves:
            state[f"convs.{i}.bias"] = torch.from_numpy(
                np.asarray(leaves["bias"], dtype=np.float32).copy())
    return state
