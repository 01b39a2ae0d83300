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

Ported: every family (D, B with the LSTM or attention, C, A; E scores
only) and every kernel (K1-K6):
  runtime     -> device selection, `.pth` loading, carries to and from
                 `cvad_tpu`'s variables, checkpoints, history, metrics, the
                 device probe (`doctor`)
  ops         -> the kernels and their plain versions, their build, losses
  models      -> families D, B, C, A and E
  data        -> synthetic clips, frame folders, decode, batching, the
                 device clip cache
  train       -> optimizer and schedulers, the tasks, `Trainer`, K steps
                 as one CUDA graph
  evaluation  -> scorers, video scoring and frame AUC, serving, the
                 detectors, bbox localization and reports, plots
  utils       -> JSON, training diagnosis, the smoke gate
  cli         -> `train`, `eval`, `serve`, `synth`, `score`, `report`,
                 `auc`, `plots`, `diagnose`, `smoke`, `doctor`
"""
