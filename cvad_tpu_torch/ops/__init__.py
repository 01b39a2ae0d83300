"""Kernels of the port and their plain PyTorch versions.

Importing the package registers the scoring kernels' forwards as
`torch.library` custom ops in the ``cvad_torch`` namespace: K1
(``tfold_conv1``), K3 (``memory_min_cosine``), K5 (``s2d_group_conv``) and
K6 (``flash_attention_forward``).  A scorer exported with `torch.export`
records them, so loading one needs this package and no model code.
"""

from cvad_tpu_torch.ops import (flash_attention, pallas_conv,  # noqa: F401
                                pallas_kernels, pallas_s2d)
