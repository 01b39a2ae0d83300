"""Configuration for the port's slices: family D and family B, serving and
training.

An own copy of the fields of `cvad_tpu.config` that the family-D and
family-B serving and training paths read; the port imports nothing of
`cvad_tpu`.  `FamilyDConfig`'s conv1 lowering knobs (`conv1_mode`,
`conv_stack`, `conv_group_impl`) take every value `cvad_tpu` documents and
route as there (`models/family_d.py::conv1_route`): where `cvad_tpu` runs
the s2d group kernel (K5), so does the port; every other lowering is an
exact relowering of the same convolution, which K1 computes directly.
Left out are `DataConfig.grayscale` and `label_policy`, which only the
frame-folder datasets read (ROADMAP Queue 1 item 6; the synthetic clips
take `channels`), and `TrainConfig.normal_only`, which no code of `cvad_tpu`
reads (family B's step trains on the normal clips).  Knobs of
`TrainConfig` that have no port yet are carried and refused where they are
read (`Trainer`), so that setting one never silently runs something else:

- ``steps_per_call > 1`` (K steps per call): ROADMAP Queue 1 item 5;
- ``device_cache='on'`` (the device clip cache): ROADMAP Queue 1 item 15;
  ``'auto'`` resolves to off.

`ParallelConfig` (the device mesh, ROADMAP Queue 1 item 14) is not
carried.
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
    """Clip windowing and batching: 8-frame RGB clips at 64x64, as the
    checkpoint-producing Avenue pipeline uses them.  Only the synthetic
    dataset is ported (`data/datasets.py::build_dataset`)."""

    dataset: str = "synthetic"
    clip_len: int = 8
    frame_size: Tuple[int, int] = (64, 64)  # (H, W)
    channels: int = 3
    stride: int = 4
    # family B's preset clamps to (0.001, 0.999)
    normalize_clamp: Tuple[float, float] = (0.0, 1.0)
    batch_size: int = 32
    prefetch: int = 2
    num_decode_threads: int = 4
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
    # K train steps per call: only 1 is ported (ROADMAP Queue 1 item 5)
    steps_per_call: int = 1
    # >0: rolling 'mid' checkpoint every N steps; restore resumes the
    # interrupted epoch at the exact batch
    save_every_steps: int = 0
    # device clip cache: 'auto' resolves to off, 'on' is not ported (ROADMAP
    # Queue 1 item 15)
    device_cache: str = "auto"


@dataclass(frozen=True)
class ExperimentConfig(_Base):
    """One config per entry point."""

    model: Union[FamilyDConfig, FamilyBConfig] = field(
        default_factory=FamilyDConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


FAMILY_D_PRESETS = ("avenue_improved", "family_d", "avenue_training_script2")
FAMILY_B_PRESETS = ("memory_ae", "family_b", "causal_anomaly_detection1")


def preset(name: str) -> ExperimentConfig:
    """Named presets of the ported families, as `cvad_tpu.config.preset`
    writes them (:356-384); the other families' presets wait for their
    slices (ROADMAP Queue 1 items 9-11)."""
    if name in FAMILY_D_PRESETS:
        return ExperimentConfig()
    if name in FAMILY_B_PRESETS:
        return ExperimentConfig(
            model=FamilyBConfig(),
            data=DataConfig(channels=1, clip_len=8, stride=2,
                            normalize_clamp=(0.001, 0.999), batch_size=4),
            optim=OptimConfig(optimizer="adam", lr=1e-6, weight_decay=1e-6,
                              schedule="plateau", grad_clip=0.1),
            train=TrainConfig(num_epochs=50,
                              best_metric="val_loss", best_mode="min",
                              eval_every=1, early_stop_patience=10,
                              reload_best=True),
        )
    raise NotImplementedError(
        f"preset {name!r} is not ported; the port trains families D "
        f"({', '.join(FAMILY_D_PRESETS)}) and B "
        f"({', '.join(FAMILY_B_PRESETS)}); the other families are ROADMAP "
        f"Queue 1 items 9-11")
