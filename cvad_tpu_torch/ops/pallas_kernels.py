"""Masked mean pairwise L1 (K2): the core of family D's consistency loss.

Counterpart of `cvad_tpu/ops/pallas_kernels.py::pairwise_l1_mean` (the
module name mirrors it).  For flat (B, N) and mask (B,) in {0, 1} it returns
(avg, n_pairs): the mean over unordered pairs i<j with both rows in the mask
of mean_k |f_ik - f_jk| (0 when there is no pair), and the pair count.

- `pairwise_l1_reference`, the plain version, is the twin of `cvad_tpu`'s
  `_pairwise_xla`: the (B, B, N) broadcast, differentiable by autograd;
- `pairwise_l1_backward_reference` is the closed-form gradient in torch ops;
- `pairwise_l1_mean` is a `torch.autograd.Function`: CUDA tensors launch the
  hand-written Hopper kernels (`csrc/pairwise_l1.cu`), forward and
  backward, or raise; CPU tensors take the two plain versions.
  ``pairwise_l1_mean.launches`` and ``pairwise_l1_mean.backward_launches``
  count kernel launches (one forward launch runs the kernel's two passes).

The mask and n_pairs get no gradient, as in `cvad_tpu`.  The derivative of
|x| at 0 is taken as 0 (torch's convention; JAX's is +1), so at exact ties
the gradient differs from `cvad_tpu`'s in the tied entries only; on the
family-D path those are the adjacency's zero diagonal, which the model's
(1 - eye) mask cuts off from every parameter.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cvad_tpu_torch.ops import _build

KERNEL_MAX_N = 8192  # row width the kernel stages in shared memory


def pairwise_l1_reference(flat: torch.Tensor, mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (`_pairwise_xla`): (avg, n_pairs) from the full
    (B, B, N) broadcast."""
    m = mask.float()
    d = (flat[:, None, :] - flat[None, :, :]).abs().mean(-1)
    b = flat.shape[0]
    upper = torch.triu(torch.ones((b, b), dtype=d.dtype, device=d.device), 1)
    w = upper * m[:, None] * m[None, :]
    n_pairs = w.sum()
    avg = torch.where(n_pairs > 0, (d * w).sum() / n_pairs.clamp(min=1.0),
                      torch.zeros_like(n_pairs))
    return avg, n_pairs


def pairwise_l1_backward_reference(flat: torch.Tensor, mask: torch.Tensor,
                                   n_pairs: torch.Tensor,
                                   cotangent: torch.Tensor) -> torch.Tensor:
    """Closed-form gradient of `avg` w.r.t. `flat`, times `cotangent`:
    g_ik = c m_i / (n_pairs N) sum_j m_j sign(f_ik - f_jk), 0 when there is
    no pair; sign(0) = 0, as autograd of |x| gives."""
    m = mask.float()
    n = flat.shape[1]
    sgn = torch.sign(flat[:, None, :] - flat[None, :, :])  # (B, B, N)
    acc = (m[None, :, None] * sgn).sum(1)                  # (B, N)
    scale = torch.where(n_pairs > 0,
                        cotangent / (n_pairs.clamp(min=1.0) * n),
                        torch.zeros_like(n_pairs))
    return acc * (scale * m[:, None])


def _check(flat: torch.Tensor, mask: torch.Tensor) -> None:
    if flat.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"pairwise_l1_mean takes float32 flat and mask, got "
                        f"{flat.dtype} and {mask.dtype}")
    if flat.dim() != 2 or mask.shape != flat.shape[:1]:
        raise ValueError(f"flat must be (B, N) and mask (B,), got "
                         f"{tuple(flat.shape)} and {tuple(mask.shape)}")
    if mask.device != flat.device:
        raise ValueError(f"mask on {mask.device}, flat on {flat.device}")
    b, n = flat.shape
    if b == 0 or not 0 < n <= KERNEL_MAX_N:
        raise ValueError(f"the kernel takes B >= 1 and 1 <= N <= "
                         f"{KERNEL_MAX_N}, got {(b, n)}")
    if not (flat.is_contiguous() and mask.is_contiguous()):
        raise ValueError("pairwise_l1_mean takes contiguous flat and mask")


def _library() -> ctypes.CDLL:
    lib = _build.library("pairwise_l1")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pairwise_l1_forward.argtypes = [p, p, p, p, p, i, i, p]
        lib.pairwise_l1_forward.restype = i
        lib.pairwise_l1_backward.argtypes = [p, p, p, p, p, i, i, p]
        lib.pairwise_l1_backward.restype = i
        lib.pairwise_l1_error_string.argtypes = [i]
        lib.pairwise_l1_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"pairwise_l1 {what} kernel launch failed: CUDA "
                           f"error {rc} "
                           f"({lib.pairwise_l1_error_string(rc).decode()})")


def _launch_forward(flat: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(flat, mask)
    b, n = flat.shape
    partial = torch.empty(b, dtype=torch.float32, device=flat.device)
    avg = torch.empty((), dtype=torch.float32, device=flat.device)
    n_pairs = torch.empty((), dtype=torch.float32, device=flat.device)
    lib = _library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.pairwise_l1_forward(flat.data_ptr(), mask.data_ptr(),
                                     partial.data_ptr(), avg.data_ptr(),
                                     n_pairs.data_ptr(), b, n, stream)
    _raise_on(lib, rc, "forward")
    pairwise_l1_mean.launches += 1
    return avg, n_pairs


def _launch_backward(flat: torch.Tensor, mask: torch.Tensor,
                     n_pairs: torch.Tensor, cotangent: torch.Tensor
                     ) -> torch.Tensor:
    _check(flat, mask)
    b, n = flat.shape
    ct = cotangent.to(torch.float32).contiguous()
    if ct.numel() != 1 or ct.device != flat.device:
        raise ValueError("the cotangent of avg must be one float on "
                         f"{flat.device}")
    grad = torch.empty_like(flat)
    lib = _library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.pairwise_l1_backward(flat.data_ptr(), mask.data_ptr(),
                                      n_pairs.data_ptr(), ct.data_ptr(),
                                      grad.data_ptr(), b, n, stream)
    _raise_on(lib, rc, "backward")
    pairwise_l1_mean.backward_launches += 1
    return grad


def _route(flat: torch.Tensor) -> str:
    if flat.device.type in ("cuda", "cpu"):
        return flat.device.type
    raise RuntimeError(f"pairwise_l1_mean runs on cuda or cpu, not "
                       f"{flat.device}")


class _PairwiseL1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, mask):
        if _route(flat) == "cuda":
            avg, n_pairs = _launch_forward(flat, mask)
        else:
            avg, n_pairs = pairwise_l1_reference(flat, mask)
        ctx.save_for_backward(flat, mask, n_pairs)
        ctx.mark_non_differentiable(n_pairs)
        return avg, n_pairs

    @staticmethod
    def backward(ctx, g_avg, _g_pairs):
        flat, mask, n_pairs = ctx.saved_tensors
        if _route(flat) == "cuda":
            grad = _launch_backward(flat, mask, n_pairs, g_avg)
        else:
            grad = pairwise_l1_backward_reference(flat, mask, n_pairs, g_avg)
        return grad, None


def pairwise_l1_mean(flat: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(avg, n_pairs) over unordered pairs {i<j, m_i = m_j = 1} of
    mean_k |f_ik - f_jk|; avg is 0 when there is no pair.  flat (B, N)
    float32, mask (B,) float32 in {0, 1}.  Differentiable w.r.t. `flat`."""
    return _PairwiseL1.apply(flat, mask)


pairwise_l1_mean.launches = 0
pairwise_l1_mean.backward_launches = 0
