"""Model registry: one model class per family config, the counterpart of
`cvad_tpu/models/registry.py`.

`build_model(cfg)` instantiates the `nn.Module` of a family's model config;
`MODEL_REGISTRY` maps each family letter (`config.FAMILY_CONFIGS`) to its
model class.  The scorer export (`evaluation/serving.py`) and the CLI build
their models through it.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from cvad_tpu_torch.config import family_of
from cvad_tpu_torch.models.family_a import CausalPipelineDetector
from cvad_tpu_torch.models.family_b import MemoryVideoAutoEncoder
from cvad_tpu_torch.models.family_c import Simple3DCNNDetector
from cvad_tpu_torch.models.family_d import CausalAnomalyDetector
from cvad_tpu_torch.models.family_e import BBoxVizDetector

MODEL_REGISTRY = {"a": CausalPipelineDetector, "b": MemoryVideoAutoEncoder,
                  "c": Simple3DCNNDetector, "d": CausalAnomalyDetector,
                  "e": BBoxVizDetector}


def build_model(cfg: Any, **kw) -> nn.Module:
    """The model of a family config, on the CPU in ``train()`` mode; `kw`
    goes to its constructor (family A's ``in_channels``).  A config of no
    family raises `KeyError`, as in `cvad_tpu`."""
    try:
        family = family_of(cfg)
    except NotImplementedError as e:
        raise KeyError(f"no model registered for config "
                       f"{type(cfg).__name__}") from e
    return MODEL_REGISTRY[family](cfg, **kw)
