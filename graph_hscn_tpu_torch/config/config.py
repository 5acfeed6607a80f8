"""Configuration schema: plain dataclasses + YAML parsing.

A copy of ``graph_hscn_tpu/config/config.py``: both packages read the same
YAML files to the same values.  Accepts the reference's YAML layout
unchanged (top-level keys data / mp / hscn / optim / pe / training — the
reference's main.py:28-63 and configs/GCN/peptides_func_GCN.yaml) and
extends it with the sections ``mesh``, ``compat`` and ``runtime``.
Differences from the reference schema, all deliberate:

- ``max_epochs`` in YAML is honored (the reference silently drops it because
  its pydantic field is named ``epochs`` — SURVEY quirk #4; we accept both).
- ``use_wandb`` may be False (the reference's validator rejects False —
  quirk #3).
- ``hscn.mp_units`` is a declared field (the reference reads it without
  declaring it — schema gap in HSCNConfig, config.py:76-86).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Sequence

import yaml

from graph_hscn_tpu_torch.config import defaults as D

DATASETS_NUM_FEATURES = {"peptides_func": 9, "peptides_struct": 9,
                         "voc_superpixels": 14}
DATASETS_NUM_CLASSES = {"peptides_func": 10, "peptides_struct": 11,
                        "voc_superpixels": 21}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass
class DataConfig:
    dataset_name: str
    pe: bool = False
    batch_size: int = D.BATCH_SIZE
    num_workers: int = D.NUM_WORKERS
    task_level: str | None = None
    num_graphs: int = 512          # synthetic dataset size (tests/bench)
    data_dir: str | None = None    # real cached arrays if present
    seed: int = 0
    num_buckets: int = 1           # >1: shape-bucketed pad budgets

    def __post_init__(self):
        if self.task_level is None:
            # Same inference rule as the reference (config.py:41-45).
            self.task_level = ("graph" if "peptides" in self.dataset_name
                               else "node")
        _check(self.batch_size > 0, "batch_size must be positive")
        _check(self.num_buckets >= 1, "num_buckets must be >= 1")


@dataclasses.dataclass
class MPNNConfig:
    conv_type: str
    activation: str
    hidden_channels: int = D.HIDDEN_CHANNELS
    num_layers: int = D.NUM_LAYERS
    dropout: float = D.DROPOUT
    use_batch_norm: bool = D.USE_BATCH_NORM
    use_layer_norm: bool = D.USE_LAYER_NORM
    # Attention heads: GPS global attention AND multi-head GAT
    # (conv_type: gat with num_heads > 1 concatenates H heads of
    # hidden_channels // H each, PyG GATConv(concat=True) semantics).
    num_heads: int = D.NUM_HEADS
    gps_local_conv: str = "gcn"     # "gcn" | "gatedgcn" (edge features)
    # Port-only (the JAX package has neither): GPS's layer, "prenorm" (the
    # JAX package's) or "graphgps" (LRGB's GraphGPS, models/gps.py:
    # GraphGPSModel), and dropout on its attention weights.
    gps_layer: str = "prenorm"
    attn_dropout: float = 0.0

    def __post_init__(self):
        _check(0.0 <= self.dropout <= 1.0, "dropout must be in [0, 1]")
        _check(0.0 <= self.attn_dropout <= 1.0,
               "attn_dropout must be in [0, 1]")
        _check(self.gps_layer in ("prenorm", "graphgps"),
               f"unknown gps_layer {self.gps_layer}")
        _check(self.gps_layer == "prenorm"
               or self.conv_type.lower() == "gps",
               "gps_layer is read by conv_type gps alone")
        _check(self.attn_dropout == 0.0 or self.gps_layer == "graphgps",
               "attn_dropout is read by gps_layer graphgps alone")
        if self.gps_layer == "graphgps":
            _check(self.gps_local_conv.lower() == "gatedgcn",
                   "gps_layer graphgps takes gps_local_conv gatedgcn (its "
                   "CustomGatedGCN)")
        _check(self.num_layers >= 1, "num_layers must be >= 1")
        _check(self.hidden_channels >= 1, "hidden_channels must be >= 1")
        if self.conv_type.lower() in ("gps", "gat"):
            _check(self.hidden_channels % self.num_heads == 0,
                   "hidden_channels must be divisible by num_heads")
            _check(self.gps_local_conv.lower() in ("gcn", "gatedgcn"),
                   f"unknown gps_local_conv {self.gps_local_conv}")
        if (self.conv_type.lower() == "gps"
                and self.hidden_channels // max(self.num_heads, 1) < 128
                and (self.num_heads > 1 or self.hidden_channels >= 128)):
            # Gate matches the advice text: at num_heads == 1 with a
            # small hidden, "use fewer heads" is unactionable noise.
            # The warning is the JAX package's, kept word for word so both
            # packages parse a config alike.  Warn, don't refuse: small
            # models may still prefer quality per param.
            import warnings
            hd = self.hidden_channels // max(self.num_heads, 1)
            warnings.warn(
                f"GPS head_dim = hidden_channels/num_heads = {hd} < 128 "
                "pads every attention contraction to the 128-wide MXU "
                f"tile (~{128 // max(hd, 1)}x FLOP-ceiling loss on TPU); "
                "prefer num_heads <= hidden_channels // 128 when "
                "hidden_channels >= 128, or accept the padding cost "
                "knowingly.", stacklevel=2)


@dataclasses.dataclass
class HSCNConfig:
    activation: str = "relu"
    lv_conv_type: str = "GAT"
    ll_conv_type: str = "GCN"
    vv_conv_type: str = "GCN"
    hidden_channels: int = D.HIDDEN_CHANNELS
    num_layers: int = D.NUM_LAYERS
    num_clusters: int = D.NUM_CLUSTERS
    cluster_epochs: int = D.CLUSTER_EPOCHS
    mp_units: Sequence[int] = dataclasses.field(
        default_factory=lambda: list(D.MP_UNITS))
    # Attention heads for the GAT relation slots (lv always, ll/vv when
    # configured as GAT).  heads > 1 concatenates H heads of
    # hidden_channels // H each (PyG GATConv(concat=True) semantics); the
    # reference hardcodes heads=1 (hscn.py:117-125).
    num_heads: int = 1
    # Opt-in virtual->local feedback relation.  The reference's HSCN has
    # no v->l edge type and pools only local nodes, so its virtual
    # pathway is output-inert (quirk #17, proven by execution —
    # tests/test_ref_shim.py::test_reference_virtual_pathway_inert);
    # this flag adds the missing hierarchical channel.  Default off for
    # reference parity.
    virtual_feedback: bool = False

    def __post_init__(self):
        _check(self.num_layers >= 1, "num_layers must be >= 1")
        _check(self.num_clusters >= 2, "num_clusters must be >= 2")
        _check(self.num_heads >= 1, "num_heads must be >= 1")
        _check(self.hidden_channels % self.num_heads == 0,
               "hidden_channels must be divisible by num_heads")


@dataclasses.dataclass
class OptimConfig:
    optim_type: str = "adamW"
    batch_accumulation: int = D.BATCH_ACCUMULATION
    clip_grad_norm: bool = D.CLIP_GRAD_NORM
    lr: float = D.LR
    weight_decay: float = D.WEIGHT_DECAY
    # LR schedule (reference: constant only).  cosine/linear decay over
    # the full run, with optional linear warmup in optimizer steps.
    schedule: str = "constant"
    warmup_steps: int = 0

    def __post_init__(self):
        # YAML 1.1 parses bare scientific notation ("5e-4") as a string.
        self.lr = float(self.lr)
        self.weight_decay = float(self.weight_decay)
        _check(0.0 <= self.lr <= 1.0, "lr must be in [0, 1]")
        _check(0.0 <= self.weight_decay <= 1.0,
               "weight_decay must be in [0, 1]")
        _check(self.optim_type.lower() in ("adagrad", "adam", "adamw"),
               f"unknown optimizer {self.optim_type}")
        _check(self.schedule.lower() in ("constant", "cosine", "linear"),
               f"unknown LR schedule {self.schedule}")
        _check(self.warmup_steps >= 0, "warmup_steps must be >= 0")


@dataclasses.dataclass
class PEConfig:
    dim_in: int = 16
    dim_emb: int = 16
    dim_pe: int = 4
    model: str = D.PE_MODEL
    layers: int = D.PE_LAYERS
    post_layers: int = D.POST_LAYERS
    eigen_max_freqs: int = D.EIG_MAX_FREQS
    eigvec_norm: str = D.EIGVEC_NORM
    eigen_laplacian_norm: str = D.EIG_LAP_NORM
    phi_hidden_dim: int = D.PHI_HIDDEN_DIM
    phi_out_dim: int = D.PHI_OUT_DIM
    pass_as_var: bool = D.PASS_AS_VAR
    use_bn: bool = D.PE_USE_BN
    # Reference applies a *randomly initialized, frozen* SignNet as a one-shot
    # transform (train.py:29-51, quirk #6).  trainable=True learns it
    # end-to-end instead.
    trainable: bool = False
    # Port-only: "signnet" (the reference's) or "lappe", GraphGPS's LapPE
    # DeepSet inside the model (models/encoders.py:LapPENodeEncoder, with
    # mp.gps_layer: graphgps): dim_pe wide, ``layers`` deep, no post MLP.
    encoder: str = "signnet"

    def __post_init__(self):
        _check(self.encoder in ("signnet", "lappe"),
               f"unknown PE encoder {self.encoder}")
        if self.encoder == "lappe":
            _check(self.model == "DeepSet" and self.post_layers == 0
                   and self.layers >= 1,
                   "the LapPE encoder is a DeepSet of layers >= 1 with no "
                   "post layers (post_layers: 0)")
            return
        # Reference signnet.py:298-299 / :305-306.
        _check(self.model in ("MLP", "DeepSet"),
               f"Unexpected SignNet model {self.model}")
        _check(self.post_layers >= 1,
               "Num layers in rho model has to be positive.")
        _check(self.dim_emb - self.dim_pe >= 1,
               f"SignNet PE size {self.dim_pe} is too large for desired "
               f"embedding size of {self.dim_emb}.")


@dataclasses.dataclass
class TrainingConfig:
    model_type: str = "gcn"
    loss_fn: str = "cross_entropy"
    metric: str = "ap"
    epochs: int = D.EPOCHS
    eval_period: int = D.EVAL_PERIOD
    min_delta: float = D.MIN_DELTA
    patience: int = D.PATIENCE
    use_wandb: bool = D.USE_WANDB
    wandb_proj_name: str | None = None
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0      # eval-periods between checkpoints; 0 = off

    def __post_init__(self):
        self.min_delta = float(self.min_delta)


@dataclasses.dataclass
class MeshConfig:
    axes: Sequence[str] = dataclasses.field(
        default_factory=lambda: list(D.MESH_AXES))
    shape: Sequence[int] = dataclasses.field(
        default_factory=lambda: list(D.MESH_SHAPE))
    # Sparse-path edge partitioning across an "edge" axis (shard_map halo
    # exchange); only meaningful for the large-graph sparse path.
    edge_partition: bool = False
    # Cuthill-McKee node reordering before contiguous-block partitioning:
    # shrinks the halo width H (per-layer all_to_all volume D*H*F).
    locality_reorder: bool = True


@dataclasses.dataclass
class CompatConfig:
    """Reference-quirk ledger (SURVEY §2.2) as explicit flags; all True
    reproduces the reference bit-for-bit where feasible."""

    double_relu: bool = True            # quirk 1 (mpnn.py:52,57)
    sigmoid_regression_score: bool = False  # quirk 10 (loss.py:19)
    vv_triangular_pattern: bool = True  # quirk 9 (hetero_data.py:68-79)
    cluster_index_shift: bool = False   # quirk 8 (off-by-one rotation) —
                                        # default fixed; True reproduces.
    frozen_random_signnet: bool = True  # quirk 6 (train.py:29-51)


@dataclasses.dataclass
class RuntimeConfig:
    matmul_precision: str = D.MATMUL_PRECISION
    # Mixed precision: bf16 compute inside the model stacks; master params,
    # logits, losses, optimizer state stay f32.
    compute_dtype: str = D.COMPUTE_DTYPE   # "float32" | "bfloat16"
    dense_path: str = "auto"   # "auto" | "dense" | "sparse"
    # "auto": the hand kernels on an accelerator, plain ops elsewhere;
    # "pallas": the kernel path everywhere (its plain version on the CPU);
    # "xla": plain ops everywhere.  The names are the JAX package's.
    spmm_backend: str = "auto"  # "auto" | "xla" | "pallas"
    # Device-resident dataset + epoch-as-a-program (train/device_data.py):
    # "auto" enables it when the packed dataset fits device_dataset_max_mb.
    device_dataset: str = "auto"   # "auto" | "on" | "off"
    device_dataset_max_mb: int = 2048
    # Fused multi-layer GCN stack (gcn + relu + dense slots only); "auto"
    # enables it on an accelerator when the config is eligible and not
    # pinned to matmul_precision: highest.
    fused_stack: str = "auto"      # "auto" | "on" | "off"
    debug_nans: bool = False
    # Multi-host: "auto" calls jax.distributed.initialize() when a
    # coordinator is configured in the environment (TPU pod slices set
    # this up; see utils/profiling.maybe_init_distributed); "on" forces
    # the call, "off" never initializes.
    multihost: str = "auto"        # "auto" | "on" | "off"
    pad_safety: float = D.PAD_SAFETY
    donate_state: bool = True
    profile_dir: str | None = None


@dataclasses.dataclass
class ExperimentConfig:
    data: DataConfig
    optim: OptimConfig
    training: TrainingConfig
    mpnn: MPNNConfig | None = None
    hscn: HSCNConfig | None = None
    pe: PEConfig | None = None
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    @property
    def model_cfg(self):
        return self.mpnn if self.mpnn is not None else self.hscn

    @property
    def project_name(self) -> str:
        # Same derivation as reference main.py:52-59.
        if self.mpnn is not None:
            return (f"{self.data.dataset_name}_{self.mpnn.conv_type}"
                    f"_{self.mpnn.num_layers}")
        return f"{self.data.dataset_name}_HSCN_{self.hscn.num_clusters}"


def refuse_graphgps(route: str, mpnn: MPNNConfig | None,
                    pe: PEConfig | None = None) -> None:
    """Raise on a mesh route given the port-only GraphGPS settings away
    from their defaults (named "section.key: value"): its BatchNorm
    statistics, attention dropout and LapPE run on one device alone."""
    found = []
    if mpnn is not None and mpnn.gps_layer != "prenorm":
        found.append(f"mp.gps_layer: {mpnn.gps_layer}")
    if pe is not None and pe.encoder != "signnet":
        found.append(f"pe.encoder: {pe.encoder}")
    if found:
        raise ValueError(f"{route} does not run {', '.join(found)}: "
                         "LRGB's GraphGPS trains on one device "
                         "(runtime.device_dataset or the host loop)")


def _filter_kwargs(cls, raw: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def load_config(path: str | Path) -> ExperimentConfig:
    with open(path) as f:
        raw = yaml.safe_load(f)
    return parse_config(raw)


def parse_config(raw: dict[str, Any]) -> ExperimentConfig:
    data = DataConfig(**_filter_kwargs(DataConfig, raw["data"]))

    tr_raw = dict(raw.get("training", {}))
    # Accept the reference YAML's `max_epochs` (quirk #4 fixed).
    if "max_epochs" in tr_raw and "epochs" not in tr_raw:
        tr_raw["epochs"] = tr_raw.pop("max_epochs")
    training = TrainingConfig(**_filter_kwargs(TrainingConfig, tr_raw))

    optim = OptimConfig(**_filter_kwargs(OptimConfig, raw.get("optim", {})))

    mpnn = hscn = None
    if "mp" in raw:
        mpnn = MPNNConfig(**_filter_kwargs(MPNNConfig, raw["mp"]))
    elif "hscn" in raw:
        hscn = HSCNConfig(**_filter_kwargs(HSCNConfig, raw["hscn"]))
    else:
        raise ValueError("Need either `mp` or `hscn` settings in config.")

    pe = None
    pe_raw = raw.get("pe", {})
    if pe_raw.get("use", False):
        pe_kw = _filter_kwargs(PEConfig, pe_raw)
        # Reference YAML calls it eig_max_freqs / eig_lap_norm.
        if "eig_max_freqs" in pe_raw:
            pe_kw["eigen_max_freqs"] = pe_raw["eig_max_freqs"]
        if "eig_lap_norm" in pe_raw:
            pe_kw["eigen_laplacian_norm"] = pe_raw["eig_lap_norm"]
        pe = PEConfig(**pe_kw)
        data.pe = True
        _check(pe.encoder != "lappe" or (
            mpnn is not None and mpnn.gps_layer == "graphgps"),
            "pe.encoder lappe is read by mp.gps_layer: graphgps alone")

    mesh = MeshConfig(**_filter_kwargs(MeshConfig, raw.get("mesh", {})))
    compat = CompatConfig(**_filter_kwargs(CompatConfig,
                                           raw.get("compat", {})))
    runtime = RuntimeConfig(**_filter_kwargs(RuntimeConfig,
                                             raw.get("runtime", {})))
    return ExperimentConfig(data=data, optim=optim, training=training,
                            mpnn=mpnn, hscn=hscn, pe=pe, mesh=mesh,
                            compat=compat, runtime=runtime)
