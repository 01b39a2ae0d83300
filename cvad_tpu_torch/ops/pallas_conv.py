"""T-folded conv1 (K1): family D's first Conv3d without its bias.

Counterpart of `cvad_tpu/ops/pallas_conv.py` (the module name mirrors it).
There the TPU kernel folds T into channels so that one 2-D conv over
(B, H+2, W+2, (T+2)*C) with block-banded weights (3, 3, (T+2)*C, T*O) emits
every T output at once.  Here:

- `fold_input` / `fold_kernel` build that folded form in torch's layout;
- `tfold_conv1_reference`, the plain version, is the folded `F.conv2d`
  unfolded back to (B, O, T, Ho, Wo), accumulated in float32;
- `tfold_conv1` is a `torch.autograd.Function`.  Its forward runs the
  hand-written Hopper kernel (`csrc/tfold_conv1.cu`) for CUDA tensors and
  the plain version for CPU tensors, and for nothing else.  Its backward
  runs through the plain version, as `cvad_tpu` takes `jax.vjp` of its
  reference conv (`cvad_tpu/ops/pallas_conv.py:207-210`); there is no
  backward kernel there either.  The plain backward
  (`tfold_conv1_backward_reference`) is the folded conv's backward,
  written out so that the forward is not run again.  The unfolded Conv3d's
  backward computes the same function with 3/10 of the MACs, but cuDNN
  runs its float32 weight gradient ~16x slower on the H100 (3 input
  channels; PERF.md).

Bias and ReLU stay with the caller, as in `cvad_tpu`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvad_tpu_torch.ops import _build
from cvad_tpu_torch.runtime.device import sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CIN, KERNEL_COUT = 3, 16  # the one instantiation csrc/ builds
# a unit of the kernel's work: 8 output frames (one warp each), 32 output
# columns and K1_ROWS output rows (csrc/tfold_conv1.cu's kFrames, kCols)
K1_FRAMES, K1_COLS, K1_ROWS = 8, 32, (4, 1)


def kernel_takes(cin: int, cout: int) -> bool:
    """Whether K1 computes a conv1 of these widths: the kernel is built for
    3 -> 16 only.  `models.layers.TFoldConv1` sends every other width to
    cuDNN's Conv3d, decided by these shapes before any launch, as
    `cvad_tpu` runs XLA's conv at every width (its pallas_conv.py:254-259)."""
    return (cin, cout) == (KERNEL_CIN, KERNEL_COUT)


def k1_units(b: int, t: int, h: int, w: int, rows: int) -> int:
    """K1's units of work at `rows` output rows a unit: 32 output columns x
    `rows` rows x 8 frames of one clip each.  The persistent kernels launch
    as many blocks as the card holds at once, at most one a unit."""
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (-(-wo // K1_COLS) * -(-ho // rows) * -(-t // K1_FRAMES) * b)


def k1_rows(b: int, t: int, h: int, w: int, sms: int) -> int:
    """Output rows a unit of K1 covers: 4 where that gives each SM two
    units or more, else 1 (small serving batches), so that more blocks
    share the work."""
    big = K1_ROWS[0]
    return big if k1_units(b, t, h, w, big) >= 2 * sms else K1_ROWS[1]


def fold_group_size(t: int, cout: int) -> int:
    """Largest T-group size g dividing t with g*cout <= 128 (the TPU's lane
    width), as `cvad_tpu`'s (:35-45): g == t is the whole-T fold, g < t the
    group-wise fold of long windows (g = 8 at T=64, O=16), 1 no fold."""
    best = 1
    for g in range(1, t + 1):
        if t % g == 0 and g * cout <= 128:
            best = g
    return best


def fold_input(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> folded, padded (B, (T+2)*C, H+2, W+2); folded
    channel t*C + c, as in `cvad_tpu`'s (B, H+2, W+2, (T+2)*C)."""
    b, c, t, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    return xp.transpose(1, 2).reshape(b, (t + 2) * c, h + 2, w + 2)


def fold_kernel(weight: torch.Tensor, t: int) -> torch.Tensor:
    """(O, C, 3, 3, 3) -> block-banded (T*O, (T+2)*C, 3, 3): output block ti
    holds the real kernel at folded input channels [ti*C, (ti+3)*C) and exact
    zeros elsewhere."""
    o, c = weight.shape[:2]
    kf = weight.transpose(1, 2).reshape(o, 3 * c, 3, 3)  # row kt*C + c
    wd = weight.new_zeros((t * o, (t + 2) * c, 3, 3))
    for ti in range(t):
        wd[ti * o:(ti + 1) * o, ti * c:(ti + 3) * c] = kf
    return wd


def tfold_conv1_reference(x: torch.Tensor, weight: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: Conv3d(k=3, stride=(1,2,2), padding=1, no bias) of
    x (B, C, T, H, W) as the folded stride-2 conv, accumulated in float32
    (float64 for float64 operands), returned as (B, O, T, Ho, Wo) in x's
    dtype."""
    b, _, t, _, _ = x.shape
    o = weight.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(fold_input(x.to(acc)), fold_kernel(weight.to(acc), t),
                 stride=2)
    ho, wo = y.shape[-2:]
    return (y.view(b, t, o, ho, wo).transpose(1, 2).contiguous()
            .to(x.dtype))


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"tfold_conv1 takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise TypeError(f"weight must match x: got {weight.dtype} on "
                        f"{weight.device} for {x.dtype} on {x.device}")
    if x.dim() != 5 or x.shape[1] != KERNEL_CIN:
        raise ValueError(f"x must be (B, {KERNEL_CIN}, T, H, W), got "
                         f"{tuple(x.shape)}")
    if tuple(weight.shape) != (KERNEL_COUT, KERNEL_CIN, 3, 3, 3):
        raise ValueError(f"weight must be ({KERNEL_COUT}, {KERNEL_CIN}, 3, "
                         f"3, 3), got {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("tfold_conv1 takes contiguous x and weight")


def _launch(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    _check(x, weight)
    b, c, t, h, w = x.shape
    y = torch.empty((b, KERNEL_COUT, t, (h - 1) // 2 + 1, (w - 1) // 2 + 1),
                    dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.library("tfold_conv1")
    fn = lib.tfold_conv1_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = k1_rows(b, t, h, w, sm_count(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(), b, c, t, h, w,
                KERNEL_COUT, _DTYPE_CODES[x.dtype], rows, stream)
    if rc != 0:
        err = lib.tfold_conv1_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"tfold_conv1 kernel launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    tfold_conv1.launches += 1
    return y


def tfold_conv1_backward_reference(grad_y: torch.Tensor, x: torch.Tensor,
                                   weight: torch.Tensor, needs=(True, True)):
    """Plain backward, as `cvad_tpu` takes it (``jax.vjp`` of the folded
    conv): the folded stride-2 conv's backward in x's dtype, folded back.
    grad_y (B, O, T, Ho, Wo) -> (grad_x (B, C, T, H, W), grad_weight
    (O, C, 3, 3, 3)), `None` where `needs` says no.  The banded blocks of
    the folded weight gradient are summed in float32."""
    b, c, t, h, w = x.shape
    o = weight.shape[0]
    ho, wo = grad_y.shape[-2:]
    gyf = grad_y.transpose(1, 2).reshape(b, t * o, ho, wo)
    gxf, gwf, _ = torch.ops.aten.convolution_backward(
        gyf, fold_input(x), fold_kernel(weight, t), None, [2, 2], [0, 0],
        [1, 1], False, [0, 0], 1, [needs[0], needs[1], False])
    gx = gw = None
    if needs[0]:
        gx = (gxf.view(b, t + 2, c, h + 2, w + 2).transpose(1, 2)
              [:, :, 1:-1, 1:-1, 1:-1].contiguous())
    if needs[1]:
        # output block ti holds the kernel at folded inputs [ti*C, (ti+3)*C)
        acc = torch.promote_types(gwf.dtype, torch.float32)
        blocks = gwf.to(acc).view(t, o, t + 2, c, 3, 3)
        kf = sum(blocks[ti, :, ti:ti + 3] for ti in range(t))  # (O,kT,C,..)
        gw = kf.transpose(1, 2).contiguous().to(weight.dtype)
    return gx, gw


class _TFoldConv1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        if x.device.type == "cuda":
            return _launch(x, weight)
        if x.device.type == "cpu":
            return tfold_conv1_reference(x, weight)
        raise RuntimeError(f"tfold_conv1 runs on cuda or cpu, not "
                           f"{x.device}")

    @staticmethod
    def backward(ctx, grad_y):
        x, weight = ctx.saved_tensors
        return tfold_conv1_backward_reference(
            grad_y, x, weight, ctx.needs_input_grad[:2])


def tfold_conv1(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Conv3d(C=3 -> O=16, k=3, stride=(1,2,2), padding=1) without bias:
    x (B, C, T, H, W), weight (O, C, 3, 3, 3) -> (B, O, T, Ho, Wo) in x's
    dtype.  CUDA tensors launch the Hopper kernel (or raise); CPU tensors
    take `tfold_conv1_reference`.  Differentiable w.r.t. x and weight, the
    backward through the plain version.  ``tfold_conv1.launches`` counts
    kernel launches."""
    return _TFoldConv1.apply(x, weight)


tfold_conv1.launches = 0
