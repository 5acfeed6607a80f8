"""GraphMHA's attention over each graph's slot block on the H100: the
scores, the softmax over the graph's real keys, the dropout of the weights
and the product with V, forward and backward, as one hand-written kernel
family (``csrc/graph_attn.cu``, ``csrc/graph_attn_bwd.cu``).  It replaces
no Pallas kernel: the JAX package runs this attention in XLA
(``graph_hscn_tpu/models/gps.py``, ``GraphMHA``).

q, k, v [G, S, nh, hd] (the projections of the slotted layout's [G, S, H]
blocks), mask [G, S] (True = real node).  :func:`graph_attention` is the
entry point: on CPU tensors it runs :func:`graph_attention_plain`, the stock
torch ops :class:`~graph_hscn_tpu_torch.models.gps.GraphMHA` ran before the
kernel (an einsum to the [G, nh, S, S] scores, an additive ``NEG_INF`` bias
on padding keys, a float32 softmax, :func:`~graph_hscn_tpu_torch.models.
layers.dropout`, an einsum against V); on CUDA tensors it runs
:class:`GraphAttnFunction`, whose forward and backward launch the kernels
(:func:`graph_attn`, :func:`graph_attn_bwd`) or raise.

The kernels score a graph's block only in tiles of :data:`TILE` rows up to
its last real node (:func:`extent`), so padding past it costs nothing;
query rows in tiles past it come out 0 where the plain version gives them
weights over the real keys, a difference the caller's mask after the
output projection removes (their output and every gradient are the same).
In training with dropout both routes draw the bits the same way, one
``torch.rand((G, nh, S, S), generator=generator)`` at the same point in the
generator's sequence, and keep a weight where ``bits >= rate``.
"""

from __future__ import annotations

import math

import torch

from graph_hscn_tpu_torch.models.layers import dropout
from graph_hscn_tpu_torch.ops.cuda import build

# The rows of a query or key tile, the kernels' unit of work.
TILE = 32
# The widest head the kernels hold in registers.
MAX_HEAD_DIM = 64

# The additive bias on padding keys: finite, so that a block with no real
# node (the dummy graph slot) softmaxes to uniform weights, not NaN.
NEG_INF = -1e9


def graph_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, rate: float, training: bool,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """The attention in stock torch ops, [G, S, nh, hd] in v's dtype: the
    CPU path, and the reference the kernels are held to."""
    hd = q.shape[-1]
    scores = torch.einsum("gqhd,gkhd->ghqk", q, k) / math.sqrt(hd)
    bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
    attn = torch.softmax((scores + bias.to(scores.dtype)).float(), -1)
    attn = dropout(attn, rate, training, generator)
    return torch.einsum("ghqk,gkhd->gqhd", attn.to(v.dtype), v)


def extent(mask: torch.Tensor) -> torch.Tensor:
    """One past each graph's last real node, int32 [G], on the mask's
    device (no host sync): the kernels visit the tiles below it."""
    S = mask.shape[1]
    index = torch.arange(1, S + 1, dtype=torch.int32, device=mask.device)
    return torch.where(mask, index, 0).amax(1)


def _check(name: str, q, k, v, mask):
    build.check_cuda_tensors(name, q, k, v, mask)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not one "
                         "[G, S, nh, hd]")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v {q.dtype}, {k.dtype}, {v.dtype} "
                        "(one of float32/bfloat16)")
    G, S, _, hd = q.shape
    if mask.dtype != torch.bool or mask.shape != (G, S):
        raise ValueError(f"{name}: mask {mask.dtype} {tuple(mask.shape)} "
                         f"(bool [{G}, {S}])")
    if not 1 <= hd <= MAX_HEAD_DIM or G > 65535:
        raise ValueError(f"{name}: head width {hd} (1..{MAX_HEAD_DIM}) or "
                         f"{G} graphs (at most 65535)")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + ("arguments refused" if rc < 0
                              else f"CUDA error {rc}"))


def graph_attn(q, k, v, mask, ext, bits=None, rate: float = 0.0,
               keep_scale: float = 1.0):
    """The forward kernel: (out [G, S, nh, hd] in q's dtype, lse float32
    [G, nh, S], keep: None, or with ``bits`` (float32 [G, nh, S, S]) the
    keep decisions ``bits >= rate`` of the visited pairs, uint32 words
    [G, nh, S, ceil(S / 32)] as int32).  ``ext``: :func:`extent` of mask;
    kept weights are scaled by ``keep_scale``."""
    extra = () if bits is None else (bits,)
    _check("graph_attn", q, k, v, mask)
    build.check_cuda_tensors("graph_attn", q, ext, *extra)
    G, S, nh, hd = q.shape
    if ext.dtype != torch.int32 or ext.shape != (G,):
        raise ValueError(f"graph_attn: extent {ext.dtype} "
                         f"{tuple(ext.shape)} (int32 [{G}])")
    if bits is not None and (bits.dtype != torch.float32
                             or bits.shape != (G, nh, S, S)):
        raise ValueError(f"graph_attn: bits {bits.dtype} "
                         f"{tuple(bits.shape)} (float32 [{G}, {nh}, {S}, "
                         f"{S}])")
    out = torch.empty_like(q)
    lse = torch.empty(G, nh, S, dtype=torch.float32, device=q.device)
    keep = (None if bits is None else
            torch.empty(G, nh, S, -(-S // TILE), dtype=torch.int32,
                        device=q.device))
    with torch.cuda.device(q.device):
        rc = build.load("graph_attn").graph_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            int(q.dtype == torch.bfloat16), mask.data_ptr(), ext.data_ptr(),
            None if bits is None else bits.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None if keep is None else keep.data_ptr(),
            G, S, nh, hd, 1.0 / math.sqrt(hd), rate, keep_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("graph_attn", rc)
    graph_attn.launches += 1
    return out, lse, keep


graph_attn.launches = 0


def graph_attn_bwd(q, k, v, out, grad, mask, ext, lse, keep=None,
                   keep_scale: float = 1.0):
    """The backward kernels (dQ, then dK and dV): (dq, dk, dv) [G, S, nh,
    hd] in q's dtype, from :func:`graph_attn`'s out, lse and keep and the
    output's gradient ``grad`` (q's dtype and shape)."""
    extra = () if keep is None else (keep,)
    _check("graph_attn_bwd", q, k, v, mask)
    build.check_cuda_tensors("graph_attn_bwd", q, out, grad, ext, lse,
                             *extra)
    G, S, nh, hd = q.shape
    if out.shape != q.shape or grad.shape != q.shape or not (
            out.dtype == grad.dtype == q.dtype):
        raise ValueError("graph_attn_bwd: out and grad must be q's dtype "
                         "and shape")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(G, nh, S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = build.load("graph_attn_bwd").graph_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad.data_ptr(), int(q.dtype == torch.bfloat16),
            mask.data_ptr(), ext.data_ptr(), lse.data_ptr(),
            None if keep is None else keep.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), G, S, nh, hd,
            1.0 / math.sqrt(hd), keep_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("graph_attn_bwd", rc)
    graph_attn_bwd.launches += 1
    return dq, dk, dv


graph_attn_bwd.launches = 0


class GraphAttnFunction(torch.autograd.Function):
    """The kernels' attention, differentiable in q, k and v.  The forward
    keeps out, the row log-sum-exp and the packed keep decisions for the
    backward, not the draw."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ext, bits, rate, keep_scale):
        out, lse, keep = graph_attn(q, k, v, mask, ext, bits, rate,
                                    keep_scale)
        ctx.save_for_backward(q, k, v, out, mask, ext, lse, keep)
        ctx.keep_scale = keep_scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, mask, ext, lse, keep = ctx.saved_tensors
        dq, dk, dv = graph_attn_bwd(q, k, v, out, grad.contiguous(), mask,
                                    ext, lse, keep, ctx.keep_scale)
        return dq, dk, dv, None, None, None, None, None


def graph_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, rate: float, training: bool,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """Attention over each graph's real nodes, [G, S, nh, hd] in v's dtype
    (module docstring): the kernels on CUDA tensors, the plain version on
    CPU ones.  ``rate``: the dropout of the weights in training, bits from
    ``generator``."""
    if q.device.type == "cpu":
        return graph_attention_plain(q, k, v, mask, rate, training,
                                     generator)
    dropping = training and rate > 0.0
    if dropping and not rate < 1.0:
        raise ValueError(f"graph_attention: dropout rate {rate}: the kernel "
                         "takes rates in [0, 1)")
    G, S, nh, _ = q.shape
    bits = (torch.rand((G, nh, S, S), device=q.device, generator=generator)
            if dropping else None)
    return GraphAttnFunction.apply(q, k, v, mask, extent(mask), bits, rate,
                                   1.0 / (1.0 - rate) if dropping else 1.0)
