"""Models of the port.  Layout inside is torch's: (B, C, T, H, W) for family
D, (B, T, C, H, W) frames for family B.

  D `CausalAnomalyDetector`   flagship Avenue model (checkpoint parity anchor)
  B `MemoryVideoAutoEncoder`  memory-bank video autoencoder
"""

from cvad_tpu_torch.models.family_b import MemoryVideoAutoEncoder  # noqa: F401
from cvad_tpu_torch.models.family_d import CausalAnomalyDetector  # noqa: F401
