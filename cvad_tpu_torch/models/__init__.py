"""Models of the port.  Layout inside is torch's: (B, C, T, H, W) for
families D and C, (B, T, C, H, W) frames for families B and A.

  D `CausalAnomalyDetector`   flagship Avenue model (checkpoint parity anchor)
  C `Simple3DCNNDetector`     minimal 3D-CNN classifier
  B `MemoryVideoAutoEncoder`  memory-bank video autoencoder
  A `CausalPipelineDetector`  12-stage causal pipeline (the paper's model)
  E `BBoxVizDetector`         bbox-visualization stand-in (scoring only)
"""

from cvad_tpu_torch.models.family_a import CausalPipelineDetector  # noqa: F401
from cvad_tpu_torch.models.family_b import MemoryVideoAutoEncoder  # noqa: F401
from cvad_tpu_torch.models.family_c import Simple3DCNNDetector  # noqa: F401
from cvad_tpu_torch.models.family_d import CausalAnomalyDetector  # noqa: F401
from cvad_tpu_torch.models.family_e import BBoxVizDetector  # noqa: F401
