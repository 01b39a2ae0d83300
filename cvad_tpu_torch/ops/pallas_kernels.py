"""The memory-bank min cosine distance (K3) and the masked mean pairwise L1
(K2), counterparts of `cvad_tpu/ops/pallas_kernels.py` (the module name
mirrors it).

K3, `memory_min_cosine_distance(query, memory, fill)`: family B's memory
score, out[b] = clamp(min_{j < fill} (1 - clip(q^_b . m^_j, -1, 1)), 0, 2)
/ 2 with rows normalised as x * rsqrt(sum x^2 + 1e-8); 1.0 when fill is 0.

- `memory_min_cosine_distance_reference`, the plain version, is the same
  arithmetic in torch ops;
- `memory_distance_xla_reference` is the twin of `cvad_tpu`'s `_memory_xla`
  (:138-144), which normalises as x / max(||x||, 1e-8).  The two agree
  except for rows whose norm is near 1e-4 or below, where the epsilon of
  the rsqrt form starts to count;
- `memory_min_cosine_distance` is a `torch.autograd.Function`: CUDA tensors
  launch the hand-written Hopper kernel (`csrc/memory_cosine.cu`) or raise,
  CPU tensors take the plain version.  Its backward is autograd through the
  `_memory_xla` twin, as `cvad_tpu`'s custom VJP (:116-131) does; there is
  no backward kernel.  ``memory_min_cosine_distance.launches`` counts
  wrapper calls that launch (one call launches three kernels: the
  inverse norms, the tiles and the combine; it counts once).  The fill
  stays on the device: no call reads it on the host.  The kernels take
  any B, M and D, as `cvad_tpu`'s kernel takes any D (:93-113);
  `memory_plan` picks their tile and split of D from the shapes and the
  card's SM count, inside the `torch.library` custom op
  ``cvad_torch::memory_min_cosine`` (`memory_min_cosine_forward`) that the
  Function's forward calls and `torch.export` records.

K2, `pairwise_l1_mean`: for flat (B, N) and mask (B,) in {0, 1} it returns
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
  The kernels take any B and N (the flattened adjacency, causal_dim^2
  wide), as `cvad_tpu` computes any width (:184-199): the forward's blocks
  each take a pair of 16-row tiles and a 512-wide chunk of N, and a second
  pass adds their partials in a fixed order.  The backward's blocks each
  take a chunk of columns, a tile of rows i (8 a thread, in registers) and
  one of S <= 8 ranges of rows j, which they stage in shared memory;
  `pairwise_backward_plan` picks the chunk, S and the staged rows from B,
  N and the card's SM count.  Where S > 1 the S blocks of a chunk and row
  tile form one thread-block cluster and add their partial sums in order
  through distributed shared memory.  With a mask in {0, 1} the partials
  are integers, so the gradient is exact and the same for every S.

The mask and n_pairs get no gradient, as in `cvad_tpu`.  The derivative of
|x| at 0 is taken as 0 (torch's convention; JAX's is +1), so at exact ties
the gradient differs from `cvad_tpu`'s in the tied entries only; on the
family-D path those are the adjacency's zero diagonal, which the model's
(1 - eye) mask cuts off from every parameter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from cvad_tpu_torch.ops import _build
from cvad_tpu_torch.runtime.device import sm_count

_EPS = 1e-8


# ---------------------------------------------------------------------------
# K3: memory-bank min cosine distance
# ---------------------------------------------------------------------------


def memory_min_cosine_distance_reference(query: torch.Tensor,
                                         memory: torch.Tensor,
                                         fill: torch.Tensor) -> torch.Tensor:
    """Plain version of K3, with the kernel's rsqrt(sum x^2 + 1e-8)
    normalisation: (B,) in [0, 1]."""
    qn = query * torch.rsqrt((query * query).sum(-1, keepdim=True) + _EPS)
    mn = memory * torch.rsqrt((memory * memory).sum(-1, keepdim=True) + _EPS)
    return _min_distance(qn @ mn.T, fill)


def memory_distance_xla_reference(query: torch.Tensor, memory: torch.Tensor,
                                  fill: torch.Tensor) -> torch.Tensor:
    """Twin of `cvad_tpu`'s `_memory_xla`: rows normalised as
    x / max(||x||, 1e-8).  Equal to the plain version except for rows with
    a norm near 1e-4 or below.  K3's gradient is autograd through this."""
    qn = query / torch.clamp(torch.linalg.vector_norm(query, dim=-1,
                                                      keepdim=True), min=_EPS)
    mn = memory / torch.clamp(torch.linalg.vector_norm(memory, dim=-1,
                                                       keepdim=True), min=_EPS)
    return _min_distance(qn @ mn.T, fill)


def _min_distance(sims: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """Columns >= fill at distance 3, row-min of 1 - clip(sims, -1, 1),
    clamped to [0, 2] and halved; torch.amin and torch.clamp keep NaN."""
    sims = torch.clamp(sims, -1.0, 1.0)
    col = torch.arange(sims.shape[1], device=sims.device)
    valid = col < fill.reshape(())
    dists = torch.where(valid[None, :], 1.0 - sims,
                        torch.full_like(sims, 3.0))
    return torch.clamp(torch.amin(dists, dim=1), 0.0, 2.0) / 2.0


def _check_memory(query: torch.Tensor, memory: torch.Tensor,
                  fill: torch.Tensor) -> None:
    if query.dim() != 2 or memory.dim() != 2 or \
            query.shape[1] != memory.shape[1]:
        raise ValueError(f"query must be (B, D) and memory (M, D), got "
                         f"{tuple(query.shape)} and {tuple(memory.shape)}")
    if not (query.device == memory.device == fill.device):
        raise ValueError(f"query on {query.device}, memory on "
                         f"{memory.device}, fill on {fill.device}")
    if fill.numel() != 1:
        raise ValueError(f"fill must hold one count, got shape "
                         f"{tuple(fill.shape)}")


# K3's tiles, by config: (query rows, bank rows) a block computes
# (csrc/memory_cosine.cu's kTileQ / kTileM)
MEM_TILES = ((64, 64), (16, 32))
MEM_CHUNK_ALIGN = 16  # a chunk of a split D is a multiple of this


class MemoryPlan(NamedTuple):
    """K3's launch plan: tile config (an index into MEM_TILES), D cut into
    `splits` chunks of `chunk` columns (the last may be shorter), the
    tiles kernel's grid (bank tiles, query tiles, splits) and the float32
    scratch it needs (inverse norms, then partial minima or, with a split
    D, partial dot products)."""
    tile: int
    splits: int
    chunk: int
    grid: Tuple[int, int, int]
    scratch: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def memory_plan(b: int, m: int, d: int, sms: int) -> MemoryPlan:
    """The largest tile whose grid alone gives a block per SM; where no tile
    does, the smallest, with D split into chunks (multiples of
    MEM_CHUNK_ALIGN wide) until the grid does or the chunks are that
    narrow."""
    for tile, (bq, bm) in enumerate(MEM_TILES):
        tiles = _ceil(b, bq) * _ceil(m, bm)
        if tiles >= sms:
            break
    if tiles >= sms:
        chunk = MEM_CHUNK_ALIGN * _ceil(d, MEM_CHUNK_ALIGN)
    else:
        chunk = MEM_CHUNK_ALIGN * max(
            1, d // (MEM_CHUNK_ALIGN * _ceil(sms, tiles)))
    splits = _ceil(d, chunk)
    parts = splits * b * m if splits > 1 else _ceil(m, bm) * b
    return MemoryPlan(tile, splits, chunk, (_ceil(m, bm), _ceil(b, bq),
                                            splits), b + m + parts)


def _memory_library() -> ctypes.CDLL:
    lib = _build.library("memory_cosine")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.memory_min_cosine_forward.argtypes = [
            p, p, p, p, ctypes.c_longlong, p, i, i, i, i, i, i, p]
        lib.memory_min_cosine_forward.restype = i
        lib.memory_min_cosine_error_string.argtypes = [i]
        lib.memory_min_cosine_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch_memory(query: torch.Tensor, memory: torch.Tensor,
                   fill: torch.Tensor) -> torch.Tensor:
    b, d = query.shape
    m = memory.shape[0]
    if b == 0 or m == 0 or d == 0:
        raise ValueError(f"the memory kernel takes B, M and D >= 1, got "
                         f"B={b}, M={m}, D={d}")
    fill32 = fill.reshape(1).to(torch.int32)
    plan = memory_plan(b, m, d, sm_count(query.device))
    scratch = torch.empty(plan.scratch, dtype=torch.float32,
                          device=query.device)
    out = torch.empty(b, dtype=torch.float32, device=query.device)
    lib = _memory_library()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.memory_min_cosine_forward(
            query.data_ptr(), memory.data_ptr(), fill32.data_ptr(),
            scratch.data_ptr(), plan.scratch, out.data_ptr(), b, m, d,
            plan.tile, plan.splits, plan.chunk, stream)
    if rc != 0:
        raise RuntimeError(
            f"memory_min_cosine kernel launch failed: CUDA error {rc} "
            f"({lib.memory_min_cosine_error_string(rc).decode()})")
    memory_min_cosine_distance.launches += 1
    return out


@torch.library.custom_op("cvad_torch::memory_min_cosine", mutates_args=())
def memory_min_cosine_forward(query: torch.Tensor, memory: torch.Tensor,
                              fill: torch.Tensor) -> torch.Tensor:
    """K3 as the op ``torch.ops.cvad_torch.memory_min_cosine``: float32
    query (B, D), memory (M, D) and a one-element int fill on one device
    -> (B,) float32.  CUDA tensors launch the kernels (their plan,
    `memory_plan`, made here from the shapes and the card's SM count), CPU
    tensors take `memory_min_cosine_distance_reference`."""
    if _route(query) == "cuda":
        return _launch_memory(query, memory, fill)
    return memory_min_cosine_distance_reference(query, memory, fill)


@memory_min_cosine_forward.register_fake
def _(query: torch.Tensor, memory: torch.Tensor, fill: torch.Tensor
      ) -> torch.Tensor:
    return query.new_empty(query.shape[:1], dtype=torch.float32)


class _MemoryMinCosine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, memory, fill):
        ctx.save_for_backward(query, memory, fill)
        return memory_min_cosine_forward(query, memory, fill)

    @staticmethod
    def backward(ctx, g):
        query, memory, fill = ctx.saved_tensors
        with torch.enable_grad():
            q = query.detach().requires_grad_(True)
            m = memory.detach().requires_grad_(True)
            out = memory_distance_xla_reference(q, m, fill)
            dq, dm = torch.autograd.grad(out, (q, m), g)
        return dq, dm, None


def memory_min_cosine_distance(query: torch.Tensor, memory: torch.Tensor,
                               fill) -> torch.Tensor:
    """Min cosine distance of each query row to the first `fill` memory
    rows, scaled to [0, 1]: query (B, D), memory (M, D) -> (B,) float32.
    `fill` is an int tensor on the query's device (or a Python int).  The
    min-fill gate stays with the caller.  Differentiable w.r.t. query and
    memory (through the `_memory_xla` twin)."""
    q = query.to(torch.float32).contiguous()
    mem = memory.to(torch.float32).contiguous()
    if not isinstance(fill, torch.Tensor):
        fill = torch.tensor(int(fill), dtype=torch.int32, device=q.device)
    _check_memory(q, mem, fill)
    return _MemoryMinCosine.apply(q, mem, fill)


memory_min_cosine_distance.launches = 0


# ---------------------------------------------------------------------------
# K2: masked mean pairwise L1
# ---------------------------------------------------------------------------


def pairwise_l1_reference(flat: torch.Tensor, mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (`_pairwise_xla`): (avg, n_pairs) from the full
    (B, B, N) broadcast, in float32 (float64 for float64 `flat`)."""
    m = mask.to(torch.promote_types(flat.dtype, torch.float32))
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
    no pair; sign(0) = 0, as autograd of |x| gives.  In float32 (float64
    for float64 `flat`)."""
    m = mask.to(torch.promote_types(flat.dtype, torch.float32))
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
    if b == 0 or n == 0:
        raise ValueError(f"the kernel takes B >= 1 and N >= 1, got "
                         f"{(b, n)}")
    if not (flat.is_contiguous() and mask.is_contiguous()):
        raise ValueError("pairwise_l1_mean takes contiguous flat and mask")


# K2's backward blocks (csrc/pairwise_l1.cu): threads a block, rows i a
# thread holds, floats of one staged tile of rows j, the rows j of a split
# come in multiples of PAIR_BWD_SPAN_ALIGN, and a (chunk, row tile) takes
# at most PAIR_BWD_MAX_SPLITS splits (one portable cluster)
PAIR_BWD_THREADS = 256
PAIR_BWD_ROWS = 8
PAIR_BWD_STAGE = 4096
PAIR_BWD_SPAN_ALIGN = 8
PAIR_BWD_MAX_SPLITS = 8
PAIR_BWD_COLS = (32, 64, 128, 256)
PAIR_BWD_BLOCKS_PER_SM = 2  # the splits of rows j aim at this many blocks


class PairwiseBackwardPlan(NamedTuple):
    """K2's backward launch plan: `cols` columns and `rows` rows i a block
    (PAIR_BWD_THREADS // cols threads a column, PAIR_BWD_ROWS rows each),
    rows j cut into `splits` ranges of `span` rows (the last may hold
    fewer), `stage_rows` of them staged at a time; the grid (column
    chunks, row tiles, splits), whose splits of one chunk and tile are one
    cluster."""
    cols: int
    rows: int
    splits: int
    span: int
    stage_rows: int
    grid: Tuple[int, int, int]


def pairwise_backward_plan(b: int, n: int, sms: int) -> PairwiseBackwardPlan:
    """The narrowest column chunk whose row tile B fills (the widest for B
    under 8), then rows j split into the widest ranges, each a multiple of
    PAIR_BWD_SPAN_ALIGN rows and at most PAIR_BWD_MAX_SPLITS of them, that
    give the grid PAIR_BWD_BLOCKS_PER_SM blocks a SM (the most splits
    where none do)."""
    for cols in PAIR_BWD_COLS:
        rows = PAIR_BWD_THREADS // cols * PAIR_BWD_ROWS
        if rows <= b:
            break
    base = _ceil(n, cols) * _ceil(b, rows)
    want = min(PAIR_BWD_MAX_SPLITS,
               _ceil(PAIR_BWD_BLOCKS_PER_SM * sms, base))
    spans = [s for s in range(PAIR_BWD_SPAN_ALIGN * _ceil(
        b, PAIR_BWD_SPAN_ALIGN), 0, -PAIR_BWD_SPAN_ALIGN)
        if _ceil(b, s) <= PAIR_BWD_MAX_SPLITS]  # widest first
    span = next((s for s in spans if _ceil(b, s) >= want), spans[-1])
    splits = _ceil(b, span)
    return PairwiseBackwardPlan(
        cols, rows, splits, span, min(span, PAIR_BWD_STAGE // cols),
        (_ceil(n, cols), _ceil(b, rows), splits))


def _library() -> ctypes.CDLL:
    lib = _build.library("pairwise_l1")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pairwise_l1_forward.argtypes = [p, p, p, p, p, i, i, p]
        lib.pairwise_l1_forward.restype = i
        lib.pairwise_l1_forward_scratch.argtypes = [i, i]
        lib.pairwise_l1_forward_scratch.restype = ctypes.c_longlong
        lib.pairwise_l1_backward.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                             p]
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
    lib = _library()
    partial = torch.empty(lib.pairwise_l1_forward_scratch(b, n),
                          dtype=torch.float32, device=flat.device)
    avg = torch.empty((), dtype=torch.float32, device=flat.device)
    n_pairs = torch.empty((), dtype=torch.float32, device=flat.device)
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
    plan = pairwise_backward_plan(b, n, sm_count(flat.device))
    grad = torch.empty_like(flat)
    lib = _library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.pairwise_l1_backward(
            flat.data_ptr(), mask.data_ptr(), n_pairs.data_ptr(),
            ct.data_ptr(), grad.data_ptr(), b, n, plan.cols, plan.span,
            plan.stage_rows, stream)
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
