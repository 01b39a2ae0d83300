"""Configuration for the port's slices: families D, B, C, A and E, serving,
training and scoring.

An own copy of the fields of `cvad_tpu.config` that the paths of families
D, B, C, A and E read; the port imports nothing of `cvad_tpu`.  `FamilyDConfig`'s conv1 lowering knobs (`conv1_mode`,
`conv_stack`, `conv_group_impl`) take every value `cvad_tpu` documents and
route as there (`models/family_d.py::conv1_route`): where `cvad_tpu` runs
the s2d group kernel (K5), so does the port; every other lowering is an
exact relowering of the same convolution, which K1 computes directly.
Left out are `DataConfig.grayscale`, which nothing reads (decode takes
gray from ``channels == 1``, as `cvad_tpu`'s datasets do),
`FamilyCConfig.conv_mode`, whose every value `cvad_tpu` sends to the same
XLA conv (the port runs ``F.conv3d``), `FamilyAConfig.frame_hw`, which
nothing reads, and
`TrainConfig.normal_only`, which no code of `cvad_tpu` reads (family B's
step trains on the normal clips).
`ParallelConfig` is the device mesh's layout (`runtime/mesh.py`): the
data axis over the ranks of a ``torch.distributed`` world, and the time
axis that shards every trained family's clips along T
(`parallel/temporal.py`).
Configs are frozen dataclasses that write JSON as `cvad_tpu`'s do.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple, Union


def _asdict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: _asdict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [_asdict(v) for v in cfg]
    return cfg


class _Base:
    """JSON output and `replace` for all configs."""

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


CONV1_MODES = ("auto", "native", "tfold", "tfold2", "tfold3",
               "tfold_pallas", "tpair", "s2d", "cpad")
CONV_STACKS = ("auto", "ndhwc", "folded", "folded2", "folded3")
CONV_GROUP_IMPLS = ("stack", "gconv", "s2d")
TEMPORAL_ENCODERS = ("lstm", "attention")


@dataclass(frozen=True)
class DataConfig(_Base):
    """Clip windowing, decode and batching: 8-frame RGB clips at 64x64, as
    the checkpoint-producing Avenue pipeline uses them.  `dataset` is
    'synthetic' (in-memory clips) or a frame-folder tree under `root`:
    'ucsd_ped2', 'ucsd_ped2_simple' or 'avenue'
    (`data/datasets.py::build_dataset`)."""

    dataset: str = "synthetic"
    root: str = ""
    clip_len: int = 8
    frame_size: Tuple[int, int] = (64, 64)  # (H, W)
    channels: int = 3
    stride: int = 4
    # 0 = every window; else a uniform subsample of each video's windows
    max_clips_per_video: int = 0
    # family B's preset clamps to (0.001, 0.999)
    normalize_clamp: Tuple[float, float] = (0.0, 1.0)
    # none | heuristic_v1 | hardcoded_v2 | split_binary | mixed_simple |
    # ground_truth (data/labels.py)
    label_policy: str = "none"
    batch_size: int = 32
    prefetch: int = 2
    num_decode_threads: int = 4
    decode_backend: str = "auto"  # auto | native | pil | cv2 | npy
    # keep each decoded frame as uint8 (epochs after the first skip decode)
    cache_decoded: bool = True
    # host->device transfer dtype: uint8 sends 4x fewer bytes and the train
    # step normalises on the device
    transfer_dtype: str = "float32"  # float32 | uint8
    # 'easy': separable fixture recipe; 'hard': motion coherence only
    synthetic_profile: str = "easy"
    seed: int = 0

    @property
    def clip_shape(self) -> Tuple[int, int, int, int]:
        """(T, H, W, C) of one clip at the public scoring interface."""
        return (self.clip_len, *self.frame_size, self.channels)


@dataclass(frozen=True)
class FamilyDConfig(_Base):
    """Flagship causal model: 3D CNN 3->16->32->64, adaptive pool (4,4,4),
    16 causal variables, 16x16 adjacency, 128-hidden graph encoder -> 64,
    predictor 80->32->1 sigmoid."""

    name: str = "family_d"
    in_channels: int = 3
    causal_dim: int = 16
    hidden_dim: int = 128
    graph_embed_dim: int = 64
    causal_hidden: int = 32
    dropout: float = 0.3
    pool_out: Tuple[int, int, int] = (4, 4, 4)
    conv_channels: Tuple[int, int, int] = (16, 32, 64)
    # computation dtype of the conv stack and fc ('float32' | 'bfloat16');
    # parameters stay float32 and the heads run in float32
    dtype: str = "float32"
    # conv1 lowering, `cvad_tpu`'s knobs (config.py:124-149).  All are exact
    # relowerings of one conv; 'auto' resolves by the input's device:
    # 'tfold' / 'folded' on CUDA, 'native' / 'ndhwc' on the CPU.  Only
    # conv_group_impl='s2d' at long T (T*16 > 128) changes what runs: conv1
    # becomes K5 where `cvad_tpu` runs it (models/family_d.py::conv1_route)
    conv1_mode: str = "auto"  # CONV1_MODES
    conv_stack: str = "auto"  # CONV_STACKS
    conv_group_impl: str = "stack"  # CONV_GROUP_IMPLS

    def __post_init__(self):
        for name, allowed in (("conv1_mode", CONV1_MODES),
                              ("conv_stack", CONV_STACKS),
                              ("conv_group_impl", CONV_GROUP_IMPLS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"model.{name}={getattr(self, name)!r}; "
                                 f"one of {', '.join(allowed)}")


@dataclass(frozen=True)
class FamilyBConfig(_Base):
    """Memory-bank video autoencoder
    (``causal_anomaly_detection1.py:124-321``): a per-frame conv encoder 1->32->64->128->128 to a 64-d tanh latent, an
    LSTM of 64 over the frame latents (or, with
    ``temporal_encoder='attention'``, a transformer of `attn_layers` blocks
    and `attn_heads` heads, mean-pooled), a deconv decoder back to one 64x64
    frame, and a 500-slot ring buffer of normal sequence features (as wide
    as the temporal encoder's output) scored by min cosine distance once 10
    slots are filled."""

    name: str = "family_b"
    in_channels: int = 1
    latent_dim: int = 64
    conv_channels: Tuple[int, int, int, int] = (32, 64, 128, 128)
    memory_size: int = 500
    memory_min_fill: int = 10
    lstm_hidden: int = 64
    leaky_slope: float = 0.1
    # TEMPORAL_ENCODERS: 'lstm' (reference parity) or 'attention' (the
    # transformer of ops/attention.py, whose attention runs K6 on the card
    # at T % 128 == 0 and head dim % 128 == 0)
    temporal_encoder: str = "lstm"
    attn_heads: int = 4
    attn_layers: int = 2
    # computation dtype of the convs and denses ('float32' | 'bfloat16');
    # parameters, BatchNorm statistics, the latent, the temporal encoder and
    # the memory stay float32
    dtype: str = "float32"

    def __post_init__(self):
        if self.temporal_encoder not in TEMPORAL_ENCODERS:
            raise ValueError(f"model.temporal_encoder="
                             f"{self.temporal_encoder!r}; one of "
                             f"{', '.join(TEMPORAL_ENCODERS)}")


@dataclass(frozen=True)
class FamilyCConfig(_Base):
    """The minimal 3D-CNN classifier (``minicausal_vad_complete3.py:25-102``):
    three blocks of Conv3d k3 (stride 1, padding 1), BatchNorm, ReLU and max
    pool, 1->8->16->32, a global average pool and a dropout MLP
    32->16->8->1 with a sigmoid."""

    name: str = "family_c"
    # computation dtype of the conv blocks ('float32' | 'bfloat16'); the
    # parameters, BatchNorm statistics and the head stay float32
    dtype: str = "float32"
    in_channels: int = 1
    conv_channels: Tuple[int, int, int] = (8, 16, 32)
    mlp_dims: Tuple[int, int] = (16, 8)
    dropout: float = 0.3


@dataclass(frozen=True)
class FamilyAConfig(_Base):
    """The 12-stage causal pipeline (``causal_anomaly_detection.py:508-586``)
    with fixed-shape masked stages: a per-frame 2D conv backbone, a fixed-K
    detector with a validity mask, ReID, a GRU over each detection slot, a
    VAE factor head, an edge MLP over factor pairs, a dynamics MLP, the
    anomaly scorers and (``direct_variant``) a direct classifier on the
    time-pooled backbone features, blended 0.6 / 0.4."""

    name: str = "family_a"
    backbone_channels: Tuple[int, int, int, int, int] = (32, 32, 64, 128, 256)
    backbone_pool: Tuple[int, int] = (4, 6)
    max_boxes: int = 5
    num_factors: int = 6
    reid_dim: int = 64
    gru_hidden: int = 64
    traj_latent: int = 32
    direct_variant: bool = True
    # the earlier detector head (video_anomaly_detection.py): bbox and
    # confidence heads over 3 anchors, one score head
    anchor_variant: bool = False
    # backbone conv1 and bn1 take no gradient and no update (the
    # reference's apply_memory_efficient_training, :592-607)
    freeze_stem: bool = True
    # recompute the backbone's activations in the backward pass
    remat: bool = False
    score_blend: Tuple[float, float] = (0.6, 0.4)  # causal vs direct
    scorer_blend: Tuple[float, float, float] = (0.5, 0.3, 0.2)
    # computation dtype ('float32' | 'bfloat16'); parameters and BatchNorm
    # statistics stay float32, the scores and KL leave in float32
    dtype: str = "float32"


@dataclass(frozen=True)
class FamilyEConfig(_Base):
    """The bbox-visualization stand-in model
    (``avenue_training_script_bbox.py:51-101``): Conv3d 3->32, ReLU, max
    pool 2, Conv3d 32->64, ReLU, adaptive average pool to (1, 4, 4), 1,024
    features; a causal head to a 16x16 sigmoid adjacency and a sigmoid
    classifier.  Scoring only: it has no train task, in `cvad_tpu` or
    here."""

    name: str = "family_e"
    in_channels: int = 3
    conv_channels: Tuple[int, int] = (32, 64)
    causal_dim: int = 16
    hidden: int = 256


@dataclass(frozen=True)
class LossConfig(_Base):
    """Family-D loss weights: focal anomaly 1.0, acyclicity 0.01, sparsity
    0.001, consistency 0.01, structure 0.01; focal alpha/gamma 0.25/2.0;
    pseudo-label anomaly rate 5%; sparsity target 0.3 at edge threshold 0.1;
    structure band [10, 40] edges."""

    anomaly_weight: float = 1.0
    causal_weight: float = 0.01
    sparsity_weight: float = 0.001
    consistency_weight: float = 0.01
    structure_weight: float = 0.01
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pseudo_anomaly_rate: float = 0.05
    edge_threshold: float = 0.1
    target_sparsity: float = 0.3
    consistency_target: float = 0.1
    min_edges: int = 10
    max_edges: int = 40
    # family B: reconstruction-loss weight, and the combined inference
    # score 0.7 recon MSE + 0.3 memory distance
    # (causal_anomaly_detection1.py:552)
    b_recon_weight: float = 1.0
    b_score_recon: float = 0.7
    b_score_memory: float = 0.3
    # family A (causal_anomaly_detection.py:661-662): 0.4 CE + 0.3 score
    # MSE + 0.2 causal-score MSE + 0.1 KL
    a_ce: float = 0.4
    a_score_mse: float = 0.3
    a_causal_mse: float = 0.2
    a_kl: float = 0.1


@dataclass(frozen=True)
class OptimConfig(_Base):
    """Optimizer and schedule; defaults are the family-D AdamW recipe."""

    optimizer: str = "adamw"  # adamw | adam
    lr: float = 5e-4
    weight_decay: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 0.5
    # >0: clip to grad_clip only when the global norm exceeds this trigger
    clip_trigger: float = 0.0
    schedule: str = "plateau"  # plateau | cosine | step | constant
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    cosine_steps: int = 0
    step_size: int = 15
    step_gamma: float = 0.7


@dataclass(frozen=True)
class ParallelConfig(_Base):
    """The mesh over the ranks of the process group (`cvad_tpu.config`'s,
    :297-304): clip-batch data parallelism, optionally the clips sharded
    along T (families D, C, B and A)."""

    data_axis: int = 0  # 0 = every rank the time axis leaves
    temporal_axis: int = 1  # >1 shards the clips' T (halos, gathers)
    mesh_axis_names: Tuple[str, ...] = ("data", "time")

    def __post_init__(self):
        if self.data_axis < 0 or self.temporal_axis < 1:
            raise ValueError(f"parallel.data_axis={self.data_axis} (>= 0), "
                             f"temporal_axis={self.temporal_axis} (>= 1)")


@dataclass(frozen=True)
class TrainConfig(_Base):
    num_epochs: int = 80
    eval_every: int = 5
    save_interval: int = 10
    log_every: int = 20
    seed: int = 0
    dtype: str = "float32"  # float32 | bfloat16 compute
    best_metric: str = "score_range"
    best_mode: str = "max"
    early_stop_patience: int = 0  # 0 = off; family B uses 10
    reload_best: bool = False
    out_dir: str = "results"
    history_name: str = "improved_training_history.json"
    # K train steps per call: on CUDA one captured graph replays K steps
    # (train/graphs.py), on the CPU they run as a plain loop
    steps_per_call: int = 1
    # >0: rolling 'mid' checkpoint every N steps; restore resumes the
    # interrupted epoch at the exact batch
    save_every_steps: int = 0
    # device-resident clip cache (data/device_cache.py): 'auto' uses it
    # where the split is eligible and fits `device_cache_hbm_frac` of the
    # device's memory, 'on' demands it, 'off' never uses it
    device_cache: str = "auto"
    device_cache_hbm_frac: float = 0.5

    def __post_init__(self):
        if self.steps_per_call < 1:
            raise ValueError(f"train.steps_per_call={self.steps_per_call}; "
                             "at least 1")
        if self.device_cache not in ("auto", "on", "off"):
            raise ValueError(f"unknown train.device_cache "
                             f"{self.device_cache!r}; auto, on or off")
        if not 0 < self.device_cache_hbm_frac <= 1:
            raise ValueError("train.device_cache_hbm_frac="
                             f"{self.device_cache_hbm_frac}; in (0, 1]")


@dataclass(frozen=True)
class ExperimentConfig(_Base):
    """One config per entry point."""

    model: Union[FamilyDConfig, FamilyBConfig, FamilyCConfig,
                 FamilyAConfig, FamilyEConfig] = field(
                     default_factory=FamilyDConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# the model config of each family letter (the CLI's ``--family``)
FAMILY_CONFIGS = {"d": FamilyDConfig, "b": FamilyBConfig, "c": FamilyCConfig,
                  "a": FamilyAConfig, "e": FamilyEConfig}


def family_of(model_cfg: Any) -> str:
    """The family letter of a model config."""
    for family, cls in FAMILY_CONFIGS.items():
        if type(model_cfg) is cls:
            return family
    raise NotImplementedError(
        f"{type(model_cfg).__name__} is not a family the port has: "
        f"{', '.join(FAMILY_CONFIGS).upper()}")


FAMILY_D_PRESETS = ("avenue_improved", "family_d", "avenue_training_script2")
FAMILY_B_PRESETS = ("memory_ae", "family_b", "causal_anomaly_detection1")
FAMILY_C_PRESETS = ("mini3d", "family_c", "minicausal_vad_complete3")
FAMILY_A_PRESETS = ("causal_pipeline", "family_a", "causal_anomaly_detection")
FAMILY_A_ANCHOR_PRESETS = ("causal_pipeline_v0", "family_a_anchor",
                           "video_anomaly_detection")
FAMILY_E_PRESETS = ("bbox_viz", "family_e", "avenue_training_script_bbox")


def preset(name: str) -> ExperimentConfig:
    """Named presets of every family, as `cvad_tpu.config.preset` writes
    them (:356-412)."""
    if name in FAMILY_D_PRESETS:
        return ExperimentConfig()
    if name in FAMILY_C_PRESETS:
        return ExperimentConfig(
            model=FamilyCConfig(),
            data=DataConfig(channels=1, label_policy="mixed_simple",
                            stride=4, max_clips_per_video=50, batch_size=8),
            optim=OptimConfig(optimizer="adam", lr=1e-3, weight_decay=1e-5,
                              schedule="step", step_size=15, step_gamma=0.7,
                              grad_clip=1.0, clip_trigger=10.0),
            train=TrainConfig(num_epochs=40, best_metric="auc",
                              best_mode="max", eval_every=1),
        )
    if name in FAMILY_B_PRESETS:
        return ExperimentConfig(
            model=FamilyBConfig(),
            data=DataConfig(channels=1, clip_len=8, stride=2,
                            normalize_clamp=(0.001, 0.999), batch_size=4,
                            label_policy="hardcoded_v2"),
            optim=OptimConfig(optimizer="adam", lr=1e-6, weight_decay=1e-6,
                              schedule="plateau", grad_clip=0.1),
            train=TrainConfig(num_epochs=50,
                              best_metric="val_loss", best_mode="min",
                              eval_every=1, early_stop_patience=10,
                              reload_best=True),
        )
    if name in FAMILY_A_PRESETS:
        return ExperimentConfig(
            model=FamilyAConfig(),
            data=DataConfig(channels=1, clip_len=16, stride=8,
                            frame_size=(240, 360), label_policy="heuristic_v1",
                            batch_size=4),
            optim=OptimConfig(optimizer="adamw", lr=3e-4, weight_decay=1e-5,
                              schedule="cosine", grad_clip=1.0),
            train=TrainConfig(num_epochs=20, best_metric="val_acc",
                              best_mode="max", eval_every=1),
        )
    if name in FAMILY_A_ANCHOR_PRESETS:
        # the earlier pipeline: anchor detector, one score head, no direct
        # classifier; loss MSE(score, label) + 0.001 KL
        # (video_anomaly_detection.py:528), lr 1e-4 for 10 epochs (:1034-1037)
        base = preset("causal_pipeline")
        return base.replace(
            model=base.model.replace(anchor_variant=True,
                                     direct_variant=False),
            data=base.data.replace(label_policy="split_binary"),
            loss=base.loss.replace(a_ce=0.0, a_score_mse=1.0,
                                   a_causal_mse=0.0, a_kl=0.001),
            optim=base.optim.replace(lr=1e-4),
            train=base.train.replace(num_epochs=10),
        )
    if name in FAMILY_E_PRESETS:
        return ExperimentConfig(model=FamilyEConfig())
    raise KeyError(f"unknown preset: {name!r}")
