"""Flash attention (K6), the counterpart of the Pallas TPU flash attention
that `cvad_tpu/ops/attention.py::multi_head_attention` calls (:47-50;
``jax.experimental.pallas.ops.tpu.flash_attention`` of jax 0.9.0).

Layout is `cvad_tpu`'s: q, k, v (B, H, T, Dh), float32 or bfloat16.

- `attention_reference`, the plain version, is the twin of `cvad_tpu`'s jnp
  path (`attention.py:51-57`): float32 logits times the scale, -1e30 above
  the diagonal when causal, softmax, cast to v's type, then the product
  with v.
- `flash_attention(q, k, v, *, causal=False, sm_scale)` is a
  `torch.autograd.Function`: CUDA tensors launch the hand-written Hopper
  kernels (`csrc/flash_attention.cu`) or raise, CPU tensors take the plain
  version (its backward is autograd through it).  On the card the forward
  kernel returns O and the per-row logsumexp; the backward is two kernels,
  dQ (which also writes D = rowsum(dO * O), as the library computes it,
  :273-275) and then dK/dV, each recomputing P from q, k and the
  logsumexp.  It computes what the library's kernels compute: float32
  sums, the scale applied after QK^T (:408-409), the causal mask, P (and
  dS in the backward) cast to the inputs' type before its products (:471,
  :900, :918).  The kernels take Dh a positive multiple of 128 (the
  library's rule, which `flash_eligible` in `ops/attention.py` copies; the
  kernels loop over 128-wide chunks of the head dim) and T a positive
  multiple of 64 (the route sends T % 128 == 0), and raise on anything
  else; there is no fallback.
  ``flash_attention.launches``, ``.dq_launches`` and ``.dkv_launches``
  count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cvad_tpu_torch.ops import _build

KERNEL_HEAD_CHUNK = 128  # Dh must be a multiple of the kernels' chunk
KERNEL_TILE = 64         # T must be a multiple of the kernels' tile rows
_DTYPES = (torch.float32, torch.bfloat16)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, sm_scale: float = 1.0
                        ) -> torch.Tensor:
    """Plain version of K6: softmax(q k^T * sm_scale [causal]) v over
    (B, H, T, Dh), the twin of `cvad_tpu`'s jnp path; output in v's type."""
    t = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, T, Dh) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")


def _check_kernel_shape(q: torch.Tensor) -> Tuple[int, int, int]:
    b, h, t, dh = q.shape
    bh = b * h
    if dh <= 0 or dh % KERNEL_HEAD_CHUNK or t <= 0 or t % KERNEL_TILE or \
            not 0 < bh <= 65535:
        raise NotImplementedError(
            f"the flash-attention kernel takes a head dim that is a positive "
            f"multiple of {KERNEL_HEAD_CHUNK}, T a positive multiple of "
            f"{KERNEL_TILE} and 1 <= B*H <= 65535; got (B, H, T, Dh) = "
            f"{tuple(q.shape)}")
    return bh, t, dh


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_forward.argtypes = [p, p, p, p, p, i, i, i, f, i,
                                                i, p]
        lib.flash_attention_forward.restype = i
        lib.flash_attention_backward_dq.argtypes = [p, p, p, p, p, p, p, p, i,
                                                    i, i, f, i, i, p]
        lib.flash_attention_backward_dq.restype = i
        lib.flash_attention_backward_dkv.argtypes = [p, p, p, p, p, p, p, p,
                                                     i, i, i, f, i, i, p]
        lib.flash_attention_backward_dkv.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"flash_attention {what} kernel launch failed: CUDA error {rc} "
            f"({lib.flash_attention_error_string(rc).decode()})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (B, H, T, Dh) in q's type and the logsumexp (B, H, T) float32."""
    bh, t, dh = _check_kernel_shape(q)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t, dh, float(sm_scale),
            int(causal), int(q.dtype == torch.bfloat16), _stream(q))
    _raise_on(lib, rc, "forward")
    flash_attention.launches += 1
    return o, lse


def _launch_dq(q, k, v, o, lse, do, causal: bool, sm_scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ in q's type and D = rowsum(dO * O) (B, H, T) float32: the dQ
    kernel, on the current stream."""
    bh, t, dh = _check_kernel_shape(q)
    dvec = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            bh, t, dh, float(sm_scale), int(causal),
            int(q.dtype == torch.bfloat16), _stream(q))
    _raise_on(lib, rc, "dQ")
    flash_attention.dq_launches += 1
    return dq, dvec


def _launch_dkv(q, k, v, do, lse, dvec, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) in q's type: the dK/dV kernel, on the current stream, after
    `_launch_dq` has written D."""
    bh, t, dh = _check_kernel_shape(q)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, dh, float(sm_scale), int(causal),
            int(q.dtype == torch.bfloat16), _stream(q))
    _raise_on(lib, rc, "dK/dV")
    flash_attention.dkv_launches += 1
    return dk, dv


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise RuntimeError(f"flash_attention runs on cuda or cpu, not "
                       f"{x.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.causal, ctx.sm_scale = causal, sm_scale
        if _route(q) == "cuda":
            o, lse = _launch_forward(q, k, v, causal, sm_scale)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, g):
        if _route(g) == "cuda":
            q, k, v, o, lse = ctx.saved_tensors
            do = g.to(q.dtype).contiguous()
            dq, dvec = _launch_dq(q, k, v, o, lse, do, ctx.causal,
                                  ctx.sm_scale)
            grads = (dq, *_launch_dkv(q, k, v, do, lse, dvec, ctx.causal,
                                      ctx.sm_scale))
        else:
            q, k, v = ctx.saved_tensors
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
                out = attention_reference(*xs, causal=ctx.causal,
                                          sm_scale=ctx.sm_scale)
                grads = torch.autograd.grad(out, xs, g)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale [causal]) v over (B, H, T, Dh) float32 or
    bfloat16 tensors, output in their type; differentiable w.r.t. q, k and
    v.  On the card: Dh a multiple of 128 and T a multiple of 64, or it
    raises."""
    _check(q, k, v)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 float(sm_scale))


flash_attention.launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
