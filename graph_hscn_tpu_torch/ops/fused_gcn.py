"""Fused multi-layer dense GCN stack for the H100: the counterpart of
``graph_hscn_tpu/ops/pallas/fused_gcn_kernel.py`` (``fused_gcn_stack``).

On slotted batches the whole L-layer GCN stack runs as one kernel a
direction:

  forward:  h_0 = x;  h_l = act_l(A_hat (h_{l-1} W_l) + b_l)
            A_hat = D^-1/2 A D^-1/2 + diag(1/(deg+1)) (the folded self-loop
            operator), act_l = relu then dropout for hidden layers, identity
            for the last;
  backward: a reverse sweep over the stored post-dropout activations.

Pieces:
  - :func:`folded_operator` builds A_hat in float32 (plain torch: XLA
    computes it outside the TPU kernel);
  - :func:`fused_gcn_fwd` / :func:`fused_gcn_bwd` are the kernels' wrappers
    (``csrc/fused_gcn_fwd.cu``, ``csrc/fused_gcn_bwd.cu``): on CUDA tensors
    they launch the kernel or raise, on CPU tensors they run
    :func:`fused_gcn_fwd_plain` / :func:`fused_gcn_bwd_plain`, the same
    functions in plain PyTorch with the TPU kernel's rounding points;
  - :func:`plain_reference` runs a plain version as the kernels are held
    to it: in bfloat16 with its products summed in the kernels' order
    (:class:`ProductsInOrder`);
  - :class:`FusedGCNStackFunction` and :func:`fused_gcn_stack` make the
    stack differentiable in x and the parameters;
  - :func:`fused_plan` is the kernels' launch plan, a function of the
    shapes and the dtype alone: each graph block runs on a thread-block
    cluster of 4 or 8 blocks, each block owning a range of A_hat's rows
    (forward) or columns (backward), its slice of A_hat resident in shared
    memory where it fits, else streamed in tiles.

Compute dtype: it rides ``x`` (float32 or bfloat16).  A_hat and the weights
are narrowed to it, every product accumulates in float32, bias, relu and
dropout act on the float32 accumulator, hidden activations are stored in the
compute dtype and the logits in float32.

Dropout (hidden layers, after relu) takes ``dropout={"bits": [...]}``, one
int32 tensor [G, S, F_l] a hidden layer holding uint32 bit patterns (exact
tests), or ``dropout={"seed": s}`` (an int or a one-element int64 tensor on
the device): the bits are then Philox4x32-10 keyed by the seed and
countered by (element // 4, layer, graph block, 0), word element % 4, with
element = row * F_l + column.  The kernel makes them on the card and
:func:`dropout_bits_plain` makes the same bits in plain torch.  An element
is kept when its bits are >= min(int(rate * 2**32), 2**32 - 1) and then
scaled by float32(1 / (1 - rate)).  The TPU's hardware PRNG stream is not
reproduced.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from graph_hscn_tpu_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_LAYERS = 8            # csrc/fused_gcn_common.cuh kMaxLayers
THREADS = 512             # kThreads: threads a block
SMEM_LIMIT = 232448       # kSmemLimit: shared-memory bytes a block

# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC'11; the Random123 constants).
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def folded_operator(adj: torch.Tensor, add_self_loops: bool = True
                    ) -> torch.Tensor:
    """A_hat = D^-1/2 A D^-1/2 + diag(1/(deg+1)) on dense [G, S, S] blocks,
    deg the row sums (+1 for the self loop), in adj's dtype."""
    deg = adj.sum(-1) + (1.0 if add_self_loops else 0.0)
    inv = torch.rsqrt(deg.clamp_min(1e-12))
    a = adj * inv[:, :, None] * inv[:, None, :]
    if add_self_loops:
        a = a + torch.diag_embed(inv * inv)
    return a


def dropout_threshold(rate: float) -> int:
    """Bits at or above this keep an element: rate * 2**32, capped."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_scale(rate: float) -> float:
    """The kept elements' scale, float32(1 / (1 - rate)); 1 without
    dropout."""
    return float(np.float32(1.0 / (1.0 - rate))) if rate > 0.0 else 1.0


def _mulhilo32(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of m * b for uint32 values held in int64,
    computed in 16-bit halves so no int64 product overflows."""
    p0 = m * (b & 0xFFFF)                     # < 2**48
    p1 = m * (b >> 16)                        # < 2**48
    t = p0 + ((p1 & 0xFFFF) << 16)            # < 2**49
    return ((t >> 32) + (p1 >> 16)) & _MASK32, t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 counter words (any
    broadcastable shapes) and a 2-word key; returns the 4 output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits_plain(seed: int, graphs: int, slot: int, features: int,
                       layer: int, device=None) -> torch.Tensor:
    """The 32 random bits of every element of hidden layer ``layer``
    [graphs, slot, features], as int64 values in [0, 2**32): what the
    forward kernel draws for ``dropout={"seed": seed}``."""
    e = torch.arange(slot * features, dtype=torch.int64, device=device)
    g = torch.arange(graphs, dtype=torch.int64, device=device)[:, None]
    c0 = (e >> 2)[None, :].expand(graphs, -1)
    c1 = torch.full_like(c0, layer)
    c2 = g.expand(-1, e.numel())
    c3 = torch.zeros_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, seed & _MASK32,
                                      (seed >> 32) & _MASK32), -1)
    pick = (e & 3)[None, :, None].expand(graphs, -1, 1)
    return words.gather(-1, pick).reshape(graphs, slot, features)


def _dropout_inputs(dropout, rate: float, num_layers: int):
    """("none" | "bits" | "seed", payload): the bits list, or the seed."""
    if rate <= 0.0:
        return "none", None
    if not isinstance(dropout, dict) or not ({"bits", "seed"} & set(dropout)):
        raise ValueError("rate > 0 needs dropout={'seed': ...} or "
                         "{'bits': [...]}")
    if "seed" in dropout:
        return "seed", dropout["seed"]
    bits = list(dropout["bits"])
    if len(bits) != num_layers - 1:
        raise ValueError(f"need {num_layers - 1} hidden-layer bit arrays, "
                         f"got {len(bits)}")
    return "bits", bits


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def fused_gcn_fwd_plain(a_hat, x, ws, bs, rate: float = 0.0, dropout=None):
    """:func:`fused_gcn_fwd` in plain PyTorch, a transcription of the TPU
    kernel's ``_fwd_kernel``: the list of every layer's output h_1..h_L."""
    cd = x.dtype
    L = len(ws)
    source, payload = _dropout_inputs(dropout, rate, L)
    thr, scale = dropout_threshold(rate), dropout_scale(rate)
    G, S, _ = x.shape
    a = a_hat.float()
    h = x
    outs = []
    for l in range(L):
        y = torch.matmul(h.float(), ws[l].float())
        z = torch.bmm(a, y.to(cd).float()) + bs[l].float()
        if l < L - 1:
            h = torch.relu(z)
            if source != "none":
                bits = (payload[l].to(torch.int64) & _MASK32
                        if source == "bits" else
                        dropout_bits_plain(_seed_int(payload), G, S,
                                           z.shape[-1], l, z.device))
                h = torch.where(bits >= thr, h * scale, 0.0)
            h = h.to(cd)
        else:
            h = z
        outs.append(h)
    return outs


def fused_gcn_bwd_plain(a_hat, x, ws, acts, g, rate: float = 0.0):
    """:func:`fused_gcn_bwd` in plain PyTorch, a transcription of the TPU
    kernel's ``_bwd_kernel``: (dx in x's dtype, [dW_l] and [db_l] float32).
    ``acts`` are the L-1 stored hidden activations, ``g`` = dL/dh_L."""
    cd = x.dtype
    L = len(ws)
    keep_scale = dropout_scale(rate)
    at = a_hat.float().transpose(1, 2)
    dz = g.float()
    dws, dbs = [None] * L, [None] * L
    dx = None
    for l in range(L - 1, -1, -1):
        h_prev = (x if l == 0 else acts[l - 1]).float()
        dbs[l] = dz.sum(dim=(0, 1))
        dyc = torch.bmm(at, dz.to(cd).float()).to(cd).float()
        dws[l] = torch.einsum("gsk,gso->ko", h_prev, dyc)
        dh = torch.matmul(dyc, ws[l].float().t())
        if l > 0:
            dz = dh * torch.where(h_prev > 0, keep_scale, 0.0)
        else:
            dx = dh.to(cd)
    return dx, dws, dbs


class ProductsInOrder(torch.overrides.TorchFunctionMode):
    """Within ``with ProductsInOrder():`` torch.matmul and torch.bmm sum
    over their reduction index in order, k = 0, 1, .., one multiply and one
    add at a time: the order the fused kernels sum in (with bfloat16
    operands, whose products are exact in float32, their FMA chain bit for
    bit).  Every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func not in (torch.matmul, torch.bmm) or kwargs:
            return func(*args, **(kwargs or {}))
        a, b = args
        out = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]),
                          a.shape[-2], b.shape[-1],
                          dtype=torch.result_type(a, b), device=a.device)
        for k in range(a.shape[-1]):
            out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
        return out


def plain_reference(plain, a_hat, x, *rest):
    """``plain`` (:func:`fused_gcn_fwd_plain` or :func:`fused_gcn_bwd_plain`)
    on these arguments, as the card tests and chip_smoke.py hold the
    kernels to it (within 1e-5 * max|ref| an output in float32, 1e-4 in
    bfloat16): as it is in float32, under :class:`ProductsInOrder` in
    bfloat16.

    bfloat16 needs the order.  Kernel and plain version round the same
    float32 sums to bfloat16 at the same points, and their terms are exact,
    so the sums differ only in order.  cuBLAS picks its order by shape (its
    batched A_hat products in order, h W and dy W^T at some row counts not,
    at one graph block neither), and a sum next to a rounding midpoint then
    rounds one bfloat16 ulp (0.4%) away from the kernel's, an error carried
    into everything computed from it.  In the kernels' order every value
    the kernels round comes out the same, bit for bit."""
    order = (ProductsInOrder() if x.dtype == torch.bfloat16
             else contextlib.nullcontext())
    with order:
        return plain(a_hat, x, *rest)


def _check_stack(name, a_hat, x, ws):
    """Shapes and dtypes the kernels take; returns (G, S, dims)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x dtype {x.dtype} (float32/bfloat16)")
    if a_hat.dtype != x.dtype or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"{name}: a_hat and the weights must be in x's "
                        f"dtype {x.dtype}")
    if x.dim() != 3 or a_hat.shape != (x.shape[0], x.shape[1], x.shape[1]):
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [G, S, F0] or "
                         f"a_hat {tuple(a_hat.shape)} is not [G, S, S]")
    G, S, _ = x.shape
    if S % 4:
        raise ValueError(f"{name}: slot {S} is not a multiple of 4")
    if a_hat.data_ptr() % 16:
        raise ValueError(f"{name}: a_hat is not 16-byte aligned")
    if not 1 <= len(ws) <= MAX_LAYERS:
        raise ValueError(f"{name}: {len(ws)} layers (1..{MAX_LAYERS})")
    dims = [x.shape[2]]
    for w in ws:
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"{name}: weight {tuple(w.shape)} does not "
                             f"follow width {dims[-1]}")
        dims.append(w.shape[1])
    return G, S, dims


def _round4(f: int) -> int:
    return (f + 3) & ~3


def _align16(b: int) -> int:
    return (b + 15) & ~15


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How the fused kernels launch for one shape (csrc/fused_gcn_common.cuh
    ``Plan``): ``graphs * cluster`` blocks in clusters of ``cluster``; block
    r of a graph owns A_hat's rows (forward) or columns (backward)
    ``ranges(slot)[r]``; its slice of A_hat lives in shared memory when
    ``resident``, else it is streamed ``jt`` reduction rows at a time; the
    exchanged operand (y, or dz) is staged ``jt`` rows by ``fc`` feature
    columns at a time; ``smem`` dynamic shared bytes a block."""

    graphs: int
    cluster: int
    rows: int
    jt: int
    fc: int
    resident: bool
    smem: int

    @property
    def blocks(self) -> int:
        return self.graphs * self.cluster

    def ranges(self, slot: int) -> list[tuple[int, int]]:
        """[start, stop) of the rows (columns) each block of a cluster
        owns; the last ones may be short or empty."""
        return [(min(slot, r * self.rows), min(slot, (r + 1) * self.rows))
                for r in range(self.cluster)]

    def args(self) -> tuple[int, ...]:
        """The plan's arguments of the C entry points (which lay out the
        shared memory themselves and refuse a plan that does not fit)."""
        return (self.cluster, self.rows, self.jt, self.fc, int(self.resident))


def plan_smem(slot: int, rows: int, jt: int, fc: int, resident: bool,
              esize: int, own_stride: int, aux_stride: int,
              backward: bool = False) -> int:
    """Shared bytes a block (``make_layout`` in fused_gcn_common.cuh): the
    A_hat slice or tile (forward [rows, n], its row stride n padded to an
    odd number of 4-element groups; backward [n, rows]; n = slot resident,
    else jt), the block's rows of the exchanged operand, its second operand
    (h or dy, odd row stride), and the staging area (at least 16 floats a
    thread, for the split reduction's partial sums)."""
    n = slot if resident else jt
    a = n * rows if backward else rows * (n if (n // 4) % 2 else n + 4)
    return (_align16(a * esize) + rows * own_stride * 4
            + _align16(rows * aux_stride * 4)
            + max(jt * fc * 4, THREADS * 64))


def fused_plan(graphs: int, slot: int, dims, dtype,
               backward: bool = False) -> FusedPlan | None:
    """The launch plan of :func:`fused_gcn_fwd` (or, ``backward``,
    :func:`fused_gcn_bwd`) for G = ``graphs`` graph blocks of ``slot``
    rows, layer widths ``dims`` and compute ``dtype``; None where no plan
    fits the shared memory (:func:`_fused_plan`, cached: the wrappers ask
    for it at every call)."""
    return _fused_plan(graphs, slot, tuple(dims), dtype, backward)


@functools.lru_cache(maxsize=256)
def _fused_plan(graphs: int, slot: int, dims: tuple, dtype,
                backward: bool) -> FusedPlan | None:
    """:func:`fused_plan`.  In order of preference: clusters of 4 with the
    A_hat slice resident, clusters of 8 resident, clusters of 8 streaming
    A_hat.  ``fc`` is the widest feature pass whose 4 x 4 tiles need no
    more than a block's threads, ``jt`` the longest staged tile that fits,
    both evened out over their passes."""
    esize = 2 if dtype == torch.bfloat16 else 4
    fp = max(_round4(f) for f in dims[1:])
    # The second operand's row stride: dy's (backward) or the hidden h's.
    aux = (fp if backward else max([_round4(f) for f in dims[1:-1]] + [0])
           ) + 1
    for cluster, resident in ((4, True), (8, True), (8, False)):
        rows = _round4(-(-slot // cluster))
        fc_max = 4 * (THREADS // (rows // 4))
        if fc_max < 4:
            continue
        passes = -(-fp // min(fp, fc_max))
        fc = _round4(-(-fp // passes))

        def smem(jt):
            return plan_smem(slot, rows, jt, fc, resident, esize, fp, aux,
                             backward)

        if smem(4) > SMEM_LIMIT:
            continue
        lo, hi = 1, slot // 4        # the largest jt = 4k that fits
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if smem(4 * mid) <= SMEM_LIMIT:
                lo = mid
            else:
                hi = mid - 1
        steps = -(-slot // (4 * lo))
        jt = _round4(-(-slot // steps))
        return FusedPlan(graphs, cluster, rows, jt, fc, resident, smem(jt))
    return None


def _plan_for(name, G, S, dims, dtype, backward):
    plan = fused_plan(G, S, dims, dtype, backward)
    if plan is None:
        raise ValueError(f"{name}: no launch plan fits slot {S} and widths "
                         f"{dims} in {SMEM_LIMIT} bytes of shared memory")
    return plan


def max_active_clusters(plan: FusedPlan, dtype, backward: bool = False
                        ) -> int:
    """cudaOccupancyMaxActiveClusters for the kernel with this plan: how
    many of its clusters the current card holds at once."""
    name = "fused_gcn_bwd" if backward else "fused_gcn_fwd"
    n = getattr(build.load(name), f"{name}_max_clusters")(
        int(dtype == torch.bfloat16), plan.cluster, plan.smem)
    if n < 0:
        raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters failed "
                           f"(CUDA error {-n})")
    return n


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def fused_gcn_fwd(a_hat, x, ws, bs, rate: float = 0.0, dropout=None):
    """The forward of the fused stack: [h_1, ..., h_L], hidden layers in
    x's dtype, the last float32.

    a_hat [G, S, S] and x [G, S, F0] in the compute dtype (float32 or
    bfloat16), ws[l] [F_{l-1}, F_l] in it too, bs[l] [F_l] float32.
    """
    if x.device.type == "cpu":
        return fused_gcn_fwd_plain(a_hat, x, ws, bs, rate, dropout)
    L = len(ws)
    source, payload = _dropout_inputs(dropout, rate, L)
    extra = []
    if source == "bits":
        extra = payload
        if any(b.dtype != torch.int32 for b in payload):
            raise TypeError("fused_gcn_fwd: dropout bits must be int32 "
                            "(uint32 bit patterns)")
    elif source == "seed":
        seed = payload
        if not torch.is_tensor(seed):
            seed = torch.tensor([int(seed)], dtype=torch.int64,
                                device=x.device)
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError("fused_gcn_fwd: the seed is one int64")
        extra = [seed]
    build.check_cuda_tensors("fused_gcn_fwd", a_hat, x, *ws, *bs, *extra)
    G, S, dims = _check_stack("fused_gcn_fwd", a_hat, x, ws)
    for l, b in enumerate(bs):
        if b.dtype != torch.float32 or b.shape != (dims[l + 1],):
            raise ValueError(f"fused_gcn_fwd: bias {l} must be float32 "
                             f"[{dims[l + 1]}]")
    if source == "bits":
        for l, b in enumerate(payload):
            if b.shape != (G, S, dims[l + 1]):
                raise ValueError(f"fused_gcn_fwd: bits {l} {tuple(b.shape)} "
                                 f"is not [{G}, {S}, {dims[l + 1]}]")
    plan = _plan_for("fused_gcn_fwd", G, S, dims, x.dtype, False)
    outs = [torch.empty(G, S, dims[l + 1], device=x.device,
                        dtype=x.dtype if l < L - 1 else torch.float32)
            for l in range(L)]
    mode = {"none": 0, "bits": 1, "seed": 2}[source]
    with torch.cuda.device(x.device):
        rc = build.load("fused_gcn_fwd").fused_gcn_fwd(
            a_hat.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            _ptrs(ws), _ptrs(bs), _ptrs(extra) if mode == 1 else None,
            _ptrs(outs), _ints(dims), L, G, S, mode,
            dropout_threshold(rate), dropout_scale(rate),
            extra[0].data_ptr() if mode == 2 else None, *plan.args(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_gcn_fwd launch failed: "
                           + ("arguments refused" if rc < 0
                              else f"CUDA error {rc}"))
    fused_gcn_fwd.launches += 1
    return outs


fused_gcn_fwd.launches = 0


def fused_gcn_bwd(a_hat, x, ws, acts, g, rate: float = 0.0):
    """The backward of the fused stack: (dx [G, S, F0] in x's dtype,
    [dW_l] float32, [db_l] float32).  ``acts``: the L-1 hidden outputs of
    :func:`fused_gcn_fwd`; ``g`` = dL/dh_L [G, S, F_L] float32."""
    if x.device.type == "cpu":
        return fused_gcn_bwd_plain(a_hat, x, ws, acts, g, rate)
    L = len(ws)
    build.check_cuda_tensors("fused_gcn_bwd", a_hat, x, *ws, *acts, g)
    G, S, dims = _check_stack("fused_gcn_bwd", a_hat, x, ws)
    if len(acts) != L - 1 or any(
            a.dtype != x.dtype or a.shape != (G, S, dims[l + 1])
            for l, a in enumerate(acts)):
        raise ValueError("fused_gcn_bwd: acts must be the L-1 hidden "
                         "activations in x's dtype")
    if g.dtype != torch.float32 or g.shape != (G, S, dims[-1]):
        raise ValueError(f"fused_gcn_bwd: g must be float32 "
                         f"[{G}, {S}, {dims[-1]}]")
    sizes = [n for l in range(L)
             for n in (dims[l] * dims[l + 1], dims[l + 1])]
    plan = _plan_for("fused_gcn_bwd", G, S, dims, x.dtype, True)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    partial = torch.empty(plan.blocks, sum(sizes), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = build.load("fused_gcn_bwd").fused_gcn_bwd(
            a_hat.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            _ptrs(ws), _ptrs(acts) if acts else None, g.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), grads.data_ptr(),
            _ints(dims), L, G, S, dropout_scale(rate), *plan.args(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_gcn_bwd launch failed: "
                           + ("arguments refused" if rc < 0
                              else f"CUDA error {rc}"))
    fused_gcn_bwd.launches += 1
    parts = torch.split(grads, sizes)
    dws = [parts[2 * l].view(dims[l], dims[l + 1]) for l in range(L)]
    dbs = [parts[2 * l + 1] for l in range(L)]
    return dx, dws, dbs


fused_gcn_bwd.launches = 0


class FusedGCNStackFunction(torch.autograd.Function):
    """Differentiable fused stack, the counterpart of ``fused_gcn_stack``'s
    ``custom_vjp`` (fused_gcn_kernel.py:230-276).

    forward(x [G, S, F0], adj [G, S, S] raw adjacency, rate, dropout,
            kernel_0, bias_0, ..., kernel_{L-1}, bias_{L-1}) -> h_L float32.
    The forward saves A_hat and the post-dropout hidden activations;
    backward returns dx (x's dtype) and each parameter's gradient in its
    dtype, and no gradient for adj.
    """

    @staticmethod
    def forward(ctx, x, adj, rate, dropout, *params):
        L = len(params) // 2
        cd = x.dtype
        # Fold in float32 (rsqrt in bf16 loses degree precision), then
        # narrow to the compute dtype.
        a_hat = folded_operator(adj.float()).to(cd).contiguous()
        ws = [params[2 * l].to(cd).contiguous() for l in range(L)]
        bs = [params[2 * l + 1].float().contiguous() for l in range(L)]
        outs = fused_gcn_fwd(a_hat, x.contiguous(), ws, bs, rate, dropout)
        ctx.save_for_backward(a_hat, x, *ws, *outs[:-1])
        ctx.rate = rate
        ctx.num_layers = L
        ctx.param_dtypes = [p.dtype for p in params]
        return outs[-1]

    @staticmethod
    def backward(ctx, g):
        L = ctx.num_layers
        a_hat, x, *rest = ctx.saved_tensors
        ws, acts = rest[:L], rest[L:]
        dx, dws, dbs = fused_gcn_bwd(a_hat, x.contiguous(), list(ws),
                                     list(acts), g.float().contiguous(),
                                     ctx.rate)
        grads = []
        for l in range(L):
            grads += [dws[l].to(ctx.param_dtypes[2 * l]),
                      dbs[l].to(ctx.param_dtypes[2 * l + 1])]
        return (dx, None, None, None, *grads)


def fused_gcn_stack(x_blocks, adj, params, dropout=None, rate: float = 0.0):
    """x_blocks [G, S, F0] (float32, or bfloat16 for bf16 compute), adj
    [G, S, S] raw adjacency, params: list of {"kernel" [F_in, F_out],
    "bias" [F_out]}.  ``dropout`` (used only when ``rate`` > 0):
    {"seed": ...} or {"bits": [...]} (module docstring).  Returns h_L
    [G, S, F_L] float32.  The kernels run on CUDA tensors and their plain
    versions on CPU tensors."""
    flat = [t for p in params for t in (p["kernel"], p["bias"])]
    return FusedGCNStackFunction.apply(x_blocks, adj, float(rate), dropout,
                                       *flat)
