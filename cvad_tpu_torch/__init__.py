"""cvad_tpu_torch — the PyTorch/CUDA port of `cvad_tpu` for NVIDIA Hopper.

The JAX package `cvad_tpu` stays the reference; this package reproduces its
paths one slice at a time and is checked against it on the same weights and
inputs (tests/test_torch_port_*.py).  It imports `torch`, never `jax`, and
nothing of `cvad_tpu`: what it needs from there it keeps as its own copy.

Where `cvad_tpu` runs a Pallas TPU kernel, this package runs a kernel written
by hand for Hopper (`csrc/`, built with nvcc at first use and loaded with
ctypes); each kernel has a plain PyTorch version beside it that CPU tensors
take and that the tests hold the kernel against.

Layout is torch's own (N, C, T, H, W) inside the models; the public scoring
functions take (N, T, H, W, C) clips as `cvad_tpu`'s do.

Ported so far (slice 1, family-D serving; slice 2, family-D training):
  runtime     -> device selection, `.pth` loading, JAX-params and optax-state
                 conversion, training checkpoints, history, metric log
  ops         -> T-folded conv1 kernel (K1, differentiable), masked pairwise
                 L1 kernel (K2, forward and backward), their build, the
                 family-D loss
  models      -> `CausalAnomalyDetector` (family D), dropout from a generator
  data        -> synthetic clips, `SyntheticClipDataset`, `BatchLoader`
  train       -> optimizer and schedulers, train state, the family-D steps,
                 `Trainer`
  evaluation  -> scorers, bucketed batching service, HTTP front-end, eval
                 metrics
  cli         -> `train`, `serve`
"""

__version__ = "0.1.0"

from cvad_tpu_torch import config as config  # noqa: F401
