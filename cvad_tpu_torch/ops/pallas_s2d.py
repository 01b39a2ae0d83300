"""Space-to-depth + grouped-T-fold conv1 for long temporal windows: K4 and
K5.

Counterpart of `cvad_tpu/ops/pallas_s2d.py` (the module name and the public
names mirror it; so do its channels-last layouts).  Family D's conv1
(Conv3d 3 -> 16, k=3, stride (1, 2, 2), padding 1) at T > 8 folds T in
groups of g frames (g = 8 at T=64) and removes the spatial stride by
space-to-depth: 2x2 pixel cells become 4x the channels, and the stride-2
(3, 3) taps become stride-1 (2, 2) taps over cells, with one dead phase per
axis whose weights are exact zeros.  The core is then four stride-1 taps,
each an (M, K) x (K, N) product with K = (g+2)*4C and N = g*O.

- fold transforms: `s2d_fold_input`, `s2d_fold_kernel`, `s2d_foldT_input`,
  `s2d_fold_groups`, `_pad_wd`;
- plain versions: `_xla_core` (one `F.conv2d`), `_xla_dot_core` and
  `_xla_slabs_core` (per-tap `torch.einsum` accumulated in float32, or
  float64 for float64 operands: `_acc`), `_xla_groups_core`; the plain backward of K4 (`s2d_matmul_dgrad_reference`,
  `s2d_matmul_wgrad_reference`) and K5's plain weight gradient
  (`s2d_group_wgrad_reference`);
- `s2d_fold_matmul` (K4): the core over (B*n, H/2+1, W/2+1, K) per-group
  inputs and any (2, 2, K, N) weights, a `torch.autograd.Function` whose
  forward, input gradient and weight gradient are hand-written Hopper
  kernels (`csrc/s2d_conv.cu`) on one of two routes that `k4_route` picks
  from the shapes before any launch: bfloat16 on the tensor cores where K
  and N are multiples of 8 (at most 128) and Wc at most K4_TC_MAX_WC, the
  CUDA cores otherwise and in float32.  No model calls it;
- `s2d_group_conv` (K5): the same core over the n group slabs of one
  (B, H/2+1, W/2+1, n*pad128(K)) input, each slab zero-padded to 128
  channels, writing the t-major (B, H/2, W/2, T*O) output.  Its forward and
  weight gradient are kernels (`csrc/s2d_group_conv.cu`) that compute only
  the band of the folded kernel (`s2d_band_mask`); its input gradient is
  autograd through the plain version, as `cvad_tpu` takes ``jax.vjp`` of
  `_xla_slabs_core` (:505-508): conv1 is the first layer, so a train step
  never asks for it.

CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions.  ``s2d_fold_matmul.launches``, ``.dgrad_launches`` and
``.wgrad_launches``, and ``s2d_group_conv.launches`` and
``.backward_launches`` (its weight gradient) count kernel launches.  The
weight gradients are summed in float32 and cast to the weight's dtype, as
`cvad_tpu` does (:285, :482); on the CPU, float64 operands keep float64
throughout, so that a train step can be run as a float64 reference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvad_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K4_ROUTES = ("cuda_cores", "tensor_cores")  # the kernels' route codes 0, 1
TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dh, dw), tap index 2*dh + dw


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _s2d(xp: torch.Tensor) -> torch.Tensor:
    """(B, T, Hp, Wp, C) padded frames -> (B, T, Hp/2, Wp/2, 4C) cells,
    channel order (ph, pw, c)."""
    b, t, hp, wp, c = xp.shape
    xs = xp.reshape(b, t, hp // 2, 2, wp // 2, 2, c)
    return xs.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hp // 2, wp // 2,
                                                   4 * c)


def s2d_fold_input(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*n, H/2+1, W/2+1, (g+2)*4C), n = T/g groups:
    T and spatial zero-pad, 2x2 cells, then the overlapping (g+2)-frame
    group windows folded into channels, frame-major."""
    b, t, h, w, c = x.shape
    if t % g:
        raise ValueError(f"T={t} is not a multiple of g={g}")
    xs = _s2d(F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)))
    wins = xs.unfold(1, g + 2, g)               # (b, n, h2, w2, 4c, g+2)
    h2, w2 = xs.shape[2], xs.shape[3]
    return wins.permute(0, 1, 2, 3, 5, 4).reshape(b * (t // g), h2, w2,
                                                  (g + 2) * 4 * c)


def s2d_fold_kernel(kernel: torch.Tensor, g: int) -> torch.Tensor:
    """(3, 3, 3, C, O) -> (2, 2, (g+2)*4C, g*O) block-banded s2d kernel:
    spatial tap (kh, kw) lives at cell tap (kh//2, kw//2) in phase channels
    (kh%2, kw%2); the padded kh=3 / kw=3 phase is zero; column block ti
    carries T-tap kt at folded rows [(ti+kt)*4C, (ti+kt+1)*4C).
    Differentiable: the gradient sums the banded blocks."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    kp = F.pad(kernel, (0, 0, 0, 0, 0, 1, 0, 1))  # kH and kW to 4
    ks = kp.reshape(3, 2, 2, 2, 2, cin, cout).permute(0, 1, 3, 2, 4, 5, 6)
    ks = ks.reshape(3, 2, 2, 4 * cin, cout)       # kt, dh, dw, (ph,pw,c), o
    wd = kernel.new_zeros((2, 2, (g + 2) * 4 * cin, g * cout))
    for ti in range(g):
        for kt in range(3):
            wd[:, :, (ti + kt) * 4 * cin:(ti + kt + 1) * 4 * cin,
               ti * cout:(ti + 1) * cout] = ks[kt]
    return wd


def s2d_foldT_input(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H/2+1, W/2+1, (T+2)*4C): the whole-T s2d fold,
    the T halo as 4C zero channels on each side; group i's halo'd slab is
    the channel range [g*i*4C, (g*i+g+2)*4C)."""
    b, t, h, w, c = x.shape
    xs = _s2d(F.pad(x, (0, 0, 1, 1, 1, 1)))       # (b, t, h2, w2, 4c)
    xs = xs.permute(0, 2, 3, 1, 4).reshape(b, xs.shape[2], xs.shape[3],
                                           t * 4 * c)
    return F.pad(xs, (4 * c, 4 * c))


def _slab_pad(kc: int) -> int:
    return _round_up(kc, 128)


def s2d_fold_groups(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H/2+1, W/2+1, (T/g)*pad128((g+2)*4C)): the
    whole-T fold cut into the n halo'd group slabs, each zero-padded to a
    multiple of 128 channels."""
    c = x.shape[-1]
    if x.shape[1] % g:
        raise ValueError(f"T={x.shape[1]} is not a multiple of g={g}")
    xt = s2d_foldT_input(x)
    kc = (g + 2) * 4 * c
    slabs = xt.unfold(3, kc, g * 4 * c)           # (b, h2, w2, n, kc)
    slabs = F.pad(slabs, (0, _slab_pad(kc) - kc))
    return slabs.reshape(*xt.shape[:3], -1)


def s2d_band_mask(g: int, cin: int, cout: int, kp: int) -> torch.Tensor:
    """(kp, g*cout) bool: True where `s2d_fold_kernel`'s padded output can be
    nonzero in some tap, the band K5's kernels compute.  Output frame ti
    (columns [ti*cout, (ti+1)*cout)) reads input frames ti..ti+2, rows
    [ti*4*cin, (ti+3)*4*cin); the rows past (g+2)*4*cin are the slab's zero
    pad."""
    rows = torch.arange(kp)[:, None]
    first = (torch.arange(g * cout) // cout * 4 * cin)[None, :]
    return (rows >= first) & (rows < first + 12 * cin)


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation type: float32, or float64 for
    float64 operands."""
    return torch.promote_types(t.dtype, torch.float32)


def _pad_wd(wd: torch.Tensor) -> torch.Tensor:
    """(2, 2, kc, no) -> (4, pad128(kc), no): the zero rows meet the slab's
    zero pad channels."""
    kc, no = wd.shape[2], wd.shape[3]
    return F.pad(wd.reshape(4, kc, no), (0, 0, 0, _slab_pad(kc) - kc))


def _xla_core(xf: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Reference lowering: one stride-1 VALID (2, 2) `F.conv2d` in `_acc`,
    (B, Hc, Wc, K) x (2, 2, K, N) -> (B, Hc-1, Wc-1, N) in xf's dtype."""
    acc = _acc(xf)
    y = F.conv2d(xf.to(acc).permute(0, 3, 1, 2),
                 wd.to(acc).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).to(xf.dtype)


def _taps(x32: torch.Tensor, ho: int, wo: int):
    """The four (dh, dw) tap windows of x (B, Ho+1, Wo+1, ...)."""
    return [x32[:, dh:dh + ho, dw:dw + wo] for dh, dw in TAPS]


def _xla_dot_core(xf: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's forward: four tap windows, each contracted
    against its (K, N) slab with `torch.einsum`, accumulated in `_acc`,
    returned in xf's dtype."""
    _, hc, wc, kc = xf.shape
    w32 = wd.to(_acc(xf)).reshape(4, kc, -1)
    acc = None
    for tap, win in enumerate(_taps(xf.to(_acc(xf)), hc - 1, wc - 1)):
        d = torch.einsum("bhwk,kn->bhwn", win, w32[tap])
        acc = d if acc is None else acc + d
    return acc.to(xf.dtype)


def _xla_groups_core(xt: torch.Tensor, wd: torch.Tensor, g: int
                     ) -> torch.Tensor:
    """Reference of the grouped whole-T core: per-group channel slab of the
    `s2d_foldT_input` layout -> `_xla_core` -> channel concat (t-major)."""
    cs = wd.shape[2] // (g + 2)
    n = xt.shape[3] // cs - 2
    return torch.cat([_xla_core(xt[..., i * g * cs:(i * g + g + 2) * cs], wd)
                      for i in range(n // g)], dim=-1)


def _xla_slabs_core(xg: torch.Tensor, wdp: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Plain version of K5's forward on the gathered-slab layout: xg
    (B, Hc, Wc, n*kp) x wdp (4, kp, no) -> (B, Hc-1, Wc-1, n*no), per-tap
    `torch.einsum` over all slabs at once, accumulated in `_acc`, returned
    in xg's dtype.  Differentiable (K5's input gradient)."""
    b, hc, wc, _ = xg.shape
    kp, no = wdp.shape[1], wdp.shape[2]
    x32 = xg.to(_acc(xg)).reshape(b, hc, wc, n, kp)
    w32 = wdp.to(_acc(xg))
    acc = None
    for tap, win in enumerate(_taps(x32, hc - 1, wc - 1)):
        d = torch.einsum("bhwsk,kn->bhwsn", win, w32[tap])
        acc = d if acc is None else acc + d
    return acc.reshape(b, hc - 1, wc - 1, n * no).to(xg.dtype)


def s2d_matmul_dgrad_reference(ct: torch.Tensor, wd: torch.Tensor
                               ) -> torch.Tensor:
    """Plain input gradient of K4: the full correlation of the cotangent
    (B, Ho, Wo, N) with the flipped taps of wd (2, 2, K, N) -> (B, Ho+1,
    Wo+1, K), summed in `_acc`, in ct's dtype."""
    _, ho, wo, n = ct.shape
    w32 = wd.to(_acc(ct)).reshape(4, -1, n)
    ctp = F.pad(ct.to(_acc(ct)), (0, 0, 1, 1, 1, 1))
    acc = None
    for tap, (dh, dw) in enumerate(TAPS):
        win = ctp[:, 1 - dh:2 - dh + ho, 1 - dw:2 - dw + wo]
        d = torch.einsum("bhwn,kn->bhwk", win, w32[tap])
        acc = d if acc is None else acc + d
    return acc.to(ct.dtype)


def s2d_matmul_wgrad_reference(xf: torch.Tensor, ct: torch.Tensor
                               ) -> torch.Tensor:
    """Plain weight gradient of K4: per tap, x's window (M, K) transposed
    times ct (M, N), summed over the batch in `_acc` -> (2, 2, K, N) in
    that type."""
    _, ho, wo, n = ct.shape
    c32 = ct.to(_acc(ct))
    taps = [torch.einsum("bhwk,bhwn->kn", win, c32)
            for win in _taps(xf.to(_acc(ct)), ho, wo)]
    return torch.stack(taps).reshape(2, 2, xf.shape[-1], n)


def s2d_group_wgrad_reference(xg: torch.Tensor, ct: torch.Tensor, kp: int
                              ) -> torch.Tensor:
    """Plain weight gradient of K5: K4's, summed over the batch and the n
    slabs -> (4, kp, no) in `_acc`."""
    b, hc, wc, ktot = xg.shape
    n = ktot // kp
    x32 = xg.to(_acc(xg)).reshape(b, hc, wc, n, kp)
    c32 = ct.to(_acc(xg)).reshape(b, hc - 1, wc - 1, n, -1)
    return torch.stack([torch.einsum("bhwsk,bhwsn->kn", win, c32)
                        for win in _taps(x32, hc - 1, wc - 1)])


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


# K4's tensor-core kernels stage all of w beside two halos of 128 + Wc + 1
# cells (csrc/s2d_conv.cu::tc_conv_smem); at K = N = 128, the widest, the
# input gradient's fits in 227 KB up to this Wc (the card tests launch it
# there)
K4_TC_MAX_WC = 38


def k4_route(k: int, n: int, wc: int, dtype: torch.dtype) -> str:
    """K4's route for xf (R, Hc, Wc=wc, K=k) and wd (2, 2, k, n) in `dtype`,
    the same for its forward, input and weight gradient: "tensor_cores"
    (bf16 `mma.sync`) for bfloat16 where K and N are multiples of 8 (whole
    16-byte rows, 8-wide n-tiles), at most 128 each (one block's warps),
    and Wc is at most K4_TC_MAX_WC (the shared memory); "cuda_cores" (f32
    FMAs) otherwise and for float32, where TF32 would break the port's
    1e-4 card-against-CPU parity.  A model's fold with O % 8 == 0 takes the
    tensor cores in bfloat16 at 64x64 clips wherever (g+2)*4C is a multiple
    of 8 (g or C even).  This is the only place a route is chosen, before
    any launch; a launch raises for a route its kernels cannot run."""
    if (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and 0 < k <= 128 and 0 < n <= 128 and wc <= K4_TC_MAX_WC):
        return "tensor_cores"
    return "cuda_cores"


def _library() -> ctypes.CDLL:
    lib = _build.library("s2d_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.s2d_conv_forward.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.s2d_conv_dgrad.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.s2d_conv_wgrad.argtypes = [p, p, p, p] + [i] * 7 + [p]
        lib.s2d_conv_wgrad_scratch.argtypes = [i] * 7
        lib.s2d_conv_wgrad_scratch.restype = ctypes.c_longlong
        for fn in (lib.s2d_conv_forward, lib.s2d_conv_dgrad,
                   lib.s2d_conv_wgrad):
            fn.restype = i
        lib.s2d_conv_error_string.argtypes = [i]
        lib.s2d_conv_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.s2d_conv_error_string
        lib._typed = True
    return lib


def _check(what: str, x: torch.Tensor, other: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if other.dtype != x.dtype or other.device != x.device:
        raise TypeError(f"{what}: operands must match, got {x.dtype} on "
                        f"{x.device} and {other.dtype} on {other.device}")
    if x.dim() != 4 or not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{what} takes contiguous channels-last (B, H, W, "
                         f"C) operands, got {tuple(x.shape)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself, or a copy where its data does not start on 16 bytes (a
    view into a larger tensor): the kernels copy whole 16-byte rows."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(lib: ctypes.CDLL, fn: str, name: str, device: torch.device,
         *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")


def _launch_forward(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """K4's forward: x (R, Hc, Wc, K) x w4 (4, K, N) -> (R, Hc-1, Wc-1, N),
    on `k4_route`'s route."""
    _check("s2d_conv forward", x, w4)
    rows, hc, wc, k = x.shape
    n = w4.shape[-1]
    if w4.dim() != 3 or w4.shape[:2] != (4, k) or hc < 2 or wc < 2:
        raise ValueError(f"s2d_conv forward: x {tuple(x.shape)}, weights "
                         f"{tuple(w4.shape)}")
    y = torch.empty((rows, hc - 1, wc - 1, n), dtype=x.dtype,
                    device=x.device)
    if y.numel():
        x, w4 = _aligned(x), _aligned(w4)
        route = K4_ROUTES.index(k4_route(k, n, wc, x.dtype))
        _run(_library(), "s2d_conv_forward", "s2d_conv forward", x.device,
             x.data_ptr(), w4.data_ptr(), y.data_ptr(), rows, hc, wc, k, n,
             route, _DTYPE_CODES[x.dtype])
    return y


def _launch_dgrad(ct: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """K4's input gradient: ct (R, Ho, Wo, N) x w4 (4, K, N) -> dx (R, Ho+1,
    Wo+1, K): the kernel reads the taps flipped and transposed, w4[3 - t]^T
    (4, N, K), a copy of w made here."""
    _check("s2d_conv dgrad", ct, w4)
    rows, ho, wo, n = ct.shape
    k = w4.shape[1] if w4.dim() == 3 else -1
    if w4.dim() != 3 or w4.shape[0] != 4 or w4.shape[2] != n:
        raise ValueError(f"s2d_conv dgrad: cotangent {tuple(ct.shape)}, "
                         f"weights {tuple(w4.shape)}")
    dx = torch.empty((rows, ho + 1, wo + 1, k), dtype=ct.dtype,
                     device=ct.device)
    if dx.numel():
        ct = _aligned(ct)
        wflip = w4.flip(0).transpose(1, 2).contiguous()
        route = K4_ROUTES.index(k4_route(k, n, wo + 1, ct.dtype))
        _run(_library(), "s2d_conv_dgrad", "s2d_conv dgrad", ct.device,
             ct.data_ptr(), wflip.data_ptr(), dx.data_ptr(), rows, ho, wo, k,
             n, route, _DTYPE_CODES[ct.dtype])
    return dx


def _launch_wgrad(x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """K4's weight gradient: x (R, Hc, Wc, K), ct (R, Hc-1, Wc-1, N) ->
    (4, K, N) float32, summed over rows and pixels: per-block partial
    sums over a grid fixed by the shapes, then one pass that adds them in a
    fixed order (no float atomics)."""
    _check("s2d_conv wgrad", x, ct)
    rows, hc, wc, k = x.shape
    if ct.shape[:3] != (rows, hc - 1, wc - 1):
        raise ValueError(f"s2d_conv wgrad: x {tuple(x.shape)}, cotangent "
                         f"{tuple(ct.shape)}")
    n = ct.shape[3]
    out = torch.empty((4, k, n), dtype=torch.float32, device=x.device)
    if rows * (hc - 1) * (wc - 1) == 0 or out.numel() == 0:
        return out.zero_()
    x, ct = _aligned(x), _aligned(ct)
    lib = _library()
    geo = [rows, hc, wc, k, n, K4_ROUTES.index(k4_route(k, n, wc, x.dtype)),
           _DTYPE_CODES[x.dtype]]
    size = lib.s2d_conv_wgrad_scratch(*geo)
    if size < 0:
        raise ValueError(f"s2d_conv wgrad does not take x {tuple(x.shape)}, "
                         f"cotangent {tuple(ct.shape)}")
    partial = torch.empty(size, dtype=torch.float32, device=x.device)
    _run(lib, "s2d_conv_wgrad", "s2d_conv wgrad", x.device, x.data_ptr(),
         ct.data_ptr(), partial.data_ptr(), out.data_ptr(), *geo)
    return out


def _group_library() -> ctypes.CDLL:
    lib = _build.library("s2d_group_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.s2d_group_conv_forward.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.s2d_group_conv_wgrad.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.s2d_group_conv_wgrad_scratch.argtypes = [i] * 9
        lib.s2d_group_conv_wgrad_scratch.restype = ctypes.c_longlong
        for fn in (lib.s2d_group_conv_forward, lib.s2d_group_conv_wgrad):
            fn.restype = i
        lib.s2d_group_conv_error_string.argtypes = [i]
        lib.s2d_group_conv_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.s2d_group_conv_error_string
        lib._typed = True
    return lib


def _group_geometry(xg: torch.Tensor, kp: int, g: int, cin: int, cout: int
                    ) -> list:
    """The kernels' shape arguments (rows, Hc, Wc, kp, nslab, g, C, O,
    dtype) for xg (rows, Hc, Wc, nslab*kp)."""
    rows, hc, wc, ktot = xg.shape
    if ktot % kp or (g + 2) * 4 * cin > kp or hc < 2 or wc < 2:
        raise ValueError(f"s2d_group_conv: xg {tuple(xg.shape)} does not "
                         f"hold slabs of {kp} >= {(g + 2) * 4 * cin} "
                         f"channels (g={g}, C={cin})")
    return [rows, hc, wc, kp, ktot // kp, g, cin, cout,
            _DTYPE_CODES[xg.dtype]]


def _launch_group_forward(xg: torch.Tensor, wdp: torch.Tensor, g: int,
                          cin: int, cout: int) -> torch.Tensor:
    """K5's forward: xg (rows, Hc, Wc, nslab*kp) x wdp (4, kp, g*cout) ->
    (rows, Hc-1, Wc-1, nslab*g*cout), reading wdp inside its band only."""
    _check("s2d_group_conv forward", xg, wdp)
    kp = wdp.shape[1]
    if wdp.shape != (4, kp, g * cout):
        raise ValueError(f"s2d_group_conv forward: weights "
                         f"{tuple(wdp.shape)}, not (4, kp, {g * cout})")
    geo = _group_geometry(xg, kp, g, cin, cout)
    rows, hc, wc, nslab = geo[0], geo[1], geo[2], geo[4]
    y = torch.empty((rows, hc - 1, wc - 1, nslab * g * cout), dtype=xg.dtype,
                    device=xg.device)
    _run(_group_library(), "s2d_group_conv_forward", "s2d_group_conv forward",
         xg.device, xg.data_ptr(), wdp.data_ptr(), y.data_ptr(), *geo)
    return y


def _launch_group_wgrad(xg: torch.Tensor, ct: torch.Tensor, g: int,
                        cin: int, cout: int, kp: int) -> torch.Tensor:
    """K5's weight gradient: (4, kp, g*cout) float32, the band entries summed
    over rows, pixels and slabs (band-sized partials, then a pass that adds
    them in a fixed order: no float atomics), exact zeros elsewhere."""
    _check("s2d_group_conv wgrad", xg, ct)
    geo = _group_geometry(xg, kp, g, cin, cout)
    rows, hc, wc, nslab = geo[0], geo[1], geo[2], geo[4]
    if ct.shape != (rows, hc - 1, wc - 1, nslab * g * cout):
        raise ValueError(f"s2d_group_conv wgrad: cotangent "
                         f"{tuple(ct.shape)} for xg {tuple(xg.shape)}")
    out = torch.empty((4, kp, g * cout), dtype=torch.float32,
                      device=xg.device)
    size = _group_library().s2d_group_conv_wgrad_scratch(*geo)
    if size < 0:
        raise ValueError(f"s2d_group_conv wgrad does not take xg "
                         f"{tuple(xg.shape)} with g={g}, C={cin}, O={cout}")
    partial = torch.empty(size, dtype=torch.float32, device=xg.device)
    _run(_group_library(), "s2d_group_conv_wgrad", "s2d_group_conv wgrad",
         xg.device, xg.data_ptr(), ct.data_ptr(), partial.data_ptr(),
         out.data_ptr(), *geo)
    return out


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# K4: per-group core
# ---------------------------------------------------------------------------


class _S2DFoldMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, wd):
        ctx.save_for_backward(xf, wd)
        if _device(xf, "s2d_fold_matmul") == "cpu":
            return _xla_dot_core(xf, wd)
        y = _launch_forward(xf, wd.reshape(4, wd.shape[2], wd.shape[3]))
        s2d_fold_matmul.launches += 1
        return y

    @staticmethod
    def backward(ctx, ct):
        xf, wd = ctx.saved_tensors
        ct = ct.to(xf.dtype).contiguous()
        on_cpu = xf.device.type == "cpu"
        w4 = wd.reshape(4, wd.shape[2], wd.shape[3])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if on_cpu:
                dx = s2d_matmul_dgrad_reference(ct, wd)
            else:
                dx = _launch_dgrad(ct, w4)
                s2d_fold_matmul.dgrad_launches += 1
        if ctx.needs_input_grad[1]:
            if on_cpu:
                dw = s2d_matmul_wgrad_reference(xf, ct)
            else:
                dw = _launch_wgrad(xf, ct)
                s2d_fold_matmul.wgrad_launches += 1
            dw = dw.reshape(wd.shape).to(wd.dtype)
        return dx, dw


def s2d_fold_matmul(xf: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """K4: xf (B*n, H/2+1, W/2+1, (g+2)*4C) x wd (2, 2, (g+2)*4C, g*O) ->
    (B*n, H/2, W/2, g*O) in xf's dtype, float32 accumulation; wd may hold
    any values (the dense contract of `cvad_tpu`'s, :319-337).  CUDA
    tensors launch the Hopper kernels on `k4_route`'s route (forward; input
    and weight gradient in the backward, each where autograd asks for it)
    or raise; CPU tensors take the plain versions."""
    return _S2DFoldMatmul.apply(xf.contiguous(), wd.contiguous())


s2d_fold_matmul.launches = 0
s2d_fold_matmul.dgrad_launches = 0
s2d_fold_matmul.wgrad_launches = 0


# ---------------------------------------------------------------------------
# K5: whole-T grouped core (the long-window conv1)
# ---------------------------------------------------------------------------


class _S2DGroupConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, wdp, g, cin, cout):
        ctx.save_for_backward(xg, wdp)
        ctx.geo = (g, cin, cout)
        n = xg.shape[-1] // wdp.shape[1]
        if _device(xg, "s2d_group_conv") == "cpu":
            return _xla_slabs_core(xg, wdp, n)
        y = _launch_group_forward(xg, wdp, g, cin, cout)
        s2d_group_conv.launches += 1
        return y

    @staticmethod
    def backward(ctx, ct):
        xg, wdp = ctx.saved_tensors
        kp = wdp.shape[1]
        ct = ct.to(xg.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            if xg.device.type == "cpu":
                dw = s2d_group_wgrad_reference(xg, ct, kp)
            else:
                dw = _launch_group_wgrad(xg, ct, *ctx.geo, kp)
                s2d_group_conv.backward_launches += 1
            dw = dw.to(wdp.dtype)
        if ctx.needs_input_grad[0]:
            # the plain path, as cvad_tpu: conv1's input needs no gradient
            # in a train step
            with torch.enable_grad():
                a = xg.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(
                    _xla_slabs_core(a, wdp.detach(), xg.shape[-1] // kp),
                    a, ct)
        return dx, dw, None, None, None


def s2d_group_conv(xg: torch.Tensor, wd: torch.Tensor, g: int
                   ) -> torch.Tensor:
    """K5, the whole-T grouped s2d-fold conv1: xg = `s2d_fold_groups`
    output (B, H/2+1, W/2+1, n*kp), wd = `s2d_fold_kernel` output (2, 2, kc,
    g*O) -> (B, H/2, W/2, T*O) in xg's dtype, t-major folded channels.  `g`
    is the group size that built both; with it wd's shape fixes C and O.

    CUDA tensors launch the Hopper kernels (forward; weight gradient in the
    backward) or raise; CPU tensors take the plain versions.  The kernels
    hold wd to `cvad_tpu`'s contract, the "group-invariant banded kernel"
    of `cvad_tpu/ops/pallas_s2d.py:522-523`: `s2d_band_mask` marks the
    entries that `s2d_fold_kernel` can make nonzero.  The forward reads wd
    inside that band only, so it is exact for every wd the contract admits;
    the weight gradient computes the band entries and writes exact zeros
    at the others, which `s2d_fold_kernel`'s backward never reads, so the
    gradient that reaches conv1's weight is the same."""
    wdp = _pad_wd(wd)
    kc, no = wd.shape[2], wd.shape[3]
    if xg.shape[-1] % wdp.shape[1] or no % g or kc % (4 * (g + 2)):
        raise ValueError(f"xg {tuple(xg.shape)} does not hold slabs of "
                         f"{wdp.shape[1]} channels for wd {tuple(wd.shape)}"
                         f" folded with g={g}")
    return _S2DGroupConv.apply(xg.contiguous(), wdp.contiguous(), g,
                               kc // (4 * (g + 2)), no // g)


s2d_group_conv.launches = 0
s2d_group_conv.backward_launches = 0
