"""The train and eval steps of families D, C, B and A, in PyTorch.

Port of `cvad_tpu/train/tasks.py` (`prep_clips`, `_apply_updates`,
`_family_d_task`, `_family_c_task`, `_family_b_task`, `_family_a_task`,
`update_memory_masked`, `stop_bn_absorbed_biases`; `stop_frozen_stem` is
``requires_grad=False`` on family A's stem, which the model sets).  Batches
are dicts of tensors already on the model's device: ``{"clips": (B, T, H,
W, C) uint8 or float32, "labels": (B,)}``, optionally ``"valid"`` (B,)
and, for family D, ``"pseudo_targets"`` (B,).

Family C trains a BCE over the batch's (valid) clips; family A the
four-term `family_a_loss`, with its stem frozen (no gradient, no Adam
moments, no update, no weight decay; bn1's running statistics still
update) and, in training, the VAE's draw.

Family B trains on the batch's normal clips (labels == 0, and valid) with
the sufficient-statistics reconstruction loss, writes their sequence
features into the memory bank, and takes no random draw.  The train step
computes no memory score (nothing reads it); the eval step does, through
K3.

Randomness: `cvad_tpu` derives each step's dropout, pseudo-label and VAE
keys from ``fold_in(rng, step)``, which is stateless, so a resumed run
replays them.  Here each step seeds a fresh `torch.Generator` on the
device from (seed, step) (`step_seed`) and draws the pseudo-labels, the
dropout masks and family A's VAE noise from it; no generator state is
carried between steps.  A captured graph of K steps gives each step slot
its own generator, registered with the graph and seeded anew before each
replay with the seed an eager step would take (`train/graphs.py`).  The two frameworks draw different bits from the
same seed: tests set dropout to 0, pass ``pseudo_targets`` and put
`cvad_tpu`'s VAE draw into `models/family_a.py::vae_noise`.

The mesh (`runtime/mesh.py`): a task built with one runs each step on this
rank's rows (and, for family D on a time axis, frames) of the global
batch, gathers the per-row outputs over the data axis, computes the global
loss from them on every rank, draws the pseudo-labels at the global
batch's rows and every dropout mask and VAE draw through
`collectives.RowDraws`, sums the BatchNorm statistics over the data axis,
writes family B's bank from the gathered normal rows in global row order,
and all-reduces the gradient (`collectives.reduce_gradients`) before the
clip and the NaN guard; the module docstring of `parallel/collectives.py`
shows that this is the one-device step on the global batch.  The eval
steps gather their outputs (and the ``valid`` mask, so that callers trim
the padding).  Without a mesh the task runs on the trivial 1 x 1 mesh,
where each of these collectives is the identity.

Numerics on the card: the steps run inside ``cudnn.flags(deterministic=True,
allow_tf32=False, benchmark=False)``.  TF32 (cuDNN's default for float32
convolutions and their backward) keeps about three decimal digits, and the
deterministic algorithms make repeated runs, and so a resumed run,
bit-identical.  ``torch.backends.cuda.matmul.allow_tf32`` stays at its
default, False.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

from cvad_tpu_torch.config import (ExperimentConfig, FamilyAConfig,
                                   FamilyBConfig, FamilyCConfig, family_of)
from cvad_tpu_torch.evaluation import scoring
from cvad_tpu_torch.models import (CausalAnomalyDetector,
                                   CausalPipelineDetector,
                                   MemoryVideoAutoEncoder,
                                   Simple3DCNNDetector)
from cvad_tpu_torch.models.family_b import MemoryBankState
from cvad_tpu_torch.models.layers import MaskedBatchNorm
from cvad_tpu_torch.ops.losses import (binary_cross_entropy, family_a_loss,
                                       improved_loss, pseudo_labels)
from cvad_tpu_torch.parallel.collectives import (RowDraws, bind_batchnorm,
                                                 gather, gather_rows,
                                                 reduce_gradients)
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.runtime.mesh import Mesh, replicated, single_mesh
from cvad_tpu_torch.train.optim import (Optimizer, build_optimizer, flatten,
                                        global_norm, unflatten)
from cvad_tpu_torch.train.state import TrainState, trainable


class Task:
    """Model config, optimizer and the step functions of one family."""

    def __init__(self, model_cfg, tx: Optimizer, init_state: Callable,
                 train_step: Callable, eval_step: Callable):
        self.model_cfg = model_cfg
        self.tx = tx
        self.init_state = init_state
        self.train_step = train_step
        self.eval_step = eval_step


def prep_clips(clips: torch.Tensor, clamp=(0.0, 1.0)) -> torch.Tensor:
    """(B, T, H, W, C) uint8 pixels or floats on the device -> float32
    (B, C, T, H, W): uint8 / 255 there (the 4x-smaller transfer), then the
    family-B clamp when it is not (0, 1)."""
    x = scoring.prep_clips(clips)
    lo, hi = clamp
    if (lo, hi) != (0.0, 1.0):
        x = torch.clamp(x, lo, hi)
    return x


def _new_state(model: nn.Module, tx: Optimizer, device, mesh: Mesh
               ) -> TrainState:
    """`model` on CUDA unless `device` says 'cpu', its BatchNorms bound to
    the mesh's data axis and its tensors broadcast from rank 0, with a
    fresh optimizer state over its trainable parameters."""
    model = replicated(bind_batchnorm(model.to(resolve_device(device)), mesh),
                       mesh)
    return TrainState(model, tx.init(flatten(trainable(model)).detach()))


def _gather_out(out: Mapping[str, torch.Tensor], batch, mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """An eval step's per-row outputs of every rank of the data axis, with
    the batch's ``valid`` mask where it has one (the rows to keep)."""
    out = dict(out)
    if "valid" in batch:
        out["valid"] = batch["valid"]
    return {k: gather(v, mesh.data) for k, v in out.items()}



def _masked_mean_1d(x: torch.Tensor, valid) -> torch.Tensor:
    """Mean of a per-sample vector over the rows `valid` keeps."""
    if valid is None:
        return x.mean()
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _generator(device: torch.device, seed: int, step: int
               ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    return gen


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step: `seed` in the high 31 bits, the step
    in the low 32 (the counterpart of ``fold_in(key(seed), step)``)."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def card_numerics():
    """cuDNN without TF32, with deterministic algorithms and no autotuning
    (see the module docstring); a no-op for CPU tensors."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=False, deterministic=True,
                   allow_tf32=False)


@torch.no_grad()
def _apply_updates(state: TrainState, tx: Optimizer,
                   grads: Sequence[torch.Tensor], loss: torch.Tensor,
                   mesh: Mesh) -> TrainState:
    """The gradient summed over the mesh's ranks and divided by their
    count (`reduce_gradients`: the global batch's gradient, alike on every
    rank), then clip + optimizer update under the NaN guard: a non-finite
    loss or raw-gradient norm leaves the parameters, both moments and
    Adam's count untouched (one device-side select, no host branch);
    ``step`` advances either way.  Every tensor is written in place, so
    that a captured graph of K steps (`train/graphs.py`) reads at each
    replay what its last replay wrote."""
    params = state.params()
    p = flatten(params)
    g = reduce_gradients(flatten(grads), mesh)
    norm = global_norm(g)
    opt = state.opt_state
    updates, new = tx.update(g, opt, p, norm)
    ok = torch.isfinite(loss) & torch.isfinite(norm)
    torch._foreach_copy_(params, unflatten(torch.where(ok, p + updates, p),
                                           params))
    for name in ("mu", "nu", "count"):
        old = getattr(opt, name)
        old.copy_(torch.where(ok, getattr(new, name), old))
    state.step += 1
    return state


def _family_d_task(cfg: ExperimentConfig, mesh: Mesh) -> Task:
    model_cfg = cfg.model
    if cfg.train.dtype != "float32" and model_cfg.dtype == "float32":
        model_cfg = model_cfg.replace(dtype=cfg.train.dtype)
    tx = build_optimizer(cfg.optim)
    loss_cfg = cfg.loss
    clamp = cfg.data.normalize_clamp

    def init_state(seed: int, device=None) -> TrainState:
        """Fresh parameters from `seed` (torch's default initialisation,
        drawn on the CPU without touching the global generator), on CUDA
        unless `device` says 'cpu'."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = CausalAnomalyDetector(model_cfg)
        return _new_state(model, tx, device, mesh)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   seed: int, gen: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step; updates `state` in place and returns it with the
        step's metrics as 0-d device tensors.  `gen`, where given, is the
        step's generator already seeded with ``step_seed(seed,
        state.step)`` (a captured graph's slot, `train/graphs.py`)."""
        model = state.model
        clips = prep_clips(batch["clips"], clamp)
        valid = gather_rows(batch.get("valid"), mesh)
        if gen is None:
            gen = _generator(clips.device, seed, state.step)
        rows, start = mesh.rows(clips.shape[0])
        if "pseudo_targets" in batch:
            targets = gather_rows(batch["pseudo_targets"], mesh)
        else:
            targets = pseudo_labels(gen, rows, loss_cfg.pseudo_anomaly_rate,
                                    clips.device)
        params = state.params()
        with card_numerics():
            scores, adj, _ = forward(model.train(), clips,
                                     RowDraws(gen, rows, start))
            total, comps = improved_loss(gather(scores, mesh.data),
                                         gather(adj, mesh.data), targets,
                                         loss_cfg, valid=valid)
            grads = torch.autograd.grad(total, params)
        state = _apply_updates(state, tx, grads, total.detach(), mesh)
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in comps.items()}}
        return state, metrics

    def forward(model, clips, generator=None):
        """This rank's rows' outputs: the model's forward, or on a time
        axis the temporally sharded one (`parallel/temporal.py`)."""
        if mesh.time.size > 1:
            from cvad_tpu_torch.parallel.temporal import sharded_forward

            return sharded_forward(model, clips, mesh, generator)
        return model(clips, generator=generator)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        clips = prep_clips(batch["clips"], clamp)
        with card_numerics():
            scores, adj, feats = forward(state.model.eval(), clips)
        return _gather_out({"predictions": scores.reshape(-1),
                            "causal_graphs": adj, "features": feats},
                           batch, mesh)

    return Task(model_cfg, tx, init_state, train_step, eval_step)


def prep_frames(clips: torch.Tensor, clamp=(0.0, 1.0)) -> torch.Tensor:
    """(B, T, H, W, C) uint8 pixels or floats on the device -> float32
    (B, T, C, H, W), family B's frame layout, with the clamp when it is not
    (0, 1)."""
    x = scoring.prep_frames(clips)
    lo, hi = clamp
    if (lo, hi) != (0.0, 1.0):
        x = torch.clamp(x, lo, hi)
    return x


@torch.no_grad()
def update_memory_masked(state: MemoryBankState, feats: torch.Tensor,
                         mask: torch.Tensor) -> MemoryBankState:
    """Write only the rows of `feats` where `mask` is nonzero into the ring
    buffer, in FIFO order: those rows packed first (a stable sort), the
    pointer advanced by their count.  A new state, no host sync; B <= M."""
    b, m = feats.shape[0], state.memory.shape[0]
    order = torch.sort((mask == 0).to(torch.int32), stable=True).indices
    k = mask.sum().to(torch.int32)
    steps = torch.arange(b, dtype=torch.int32, device=feats.device)
    idx = ((state.ptr + steps) % m).long()
    rows = torch.where((steps < k)[:, None],
                       feats.detach()[order].to(state.memory.dtype),
                       state.memory[idx])
    return MemoryBankState(state.memory.index_copy(0, idx, rows),
                           (state.ptr + k) % m,
                           torch.clamp(state.fill + k, max=m))


_CONVS = (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d)


def bn_absorbed_biases(model: nn.Module) -> List[str]:
    """Names of the conv and deconv biases that feed straight into a
    `MaskedBatchNorm` inside an ``nn.Sequential``: family B's encoder convs
    0-3 and decoder deconvs 0-2 (the output deconv feeds a sigmoid and
    stays live), family C's ``features.{0,4,8}`` and family A's
    ``backbone.layer{1-4}.{0,3}`` (its stem conv1 is frozen)."""
    names = []
    for seq_name, seq in model.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        layers = list(seq)
        for i, (layer, nxt) in enumerate(zip(layers, layers[1:])):
            if isinstance(layer, _CONVS) and isinstance(nxt, MaskedBatchNorm):
                names.append(f"{seq_name}.{i}.bias")
    return names


def stop_bn_absorbed_biases(model: nn.Module, loss: torch.Tensor
                            ) -> List[torch.Tensor]:
    """Gradients of `loss` w.r.t. every trainable parameter
    (`TrainState.params` order), with exactly zero for the BN-absorbed biases: BatchNorm's batch
    mean cancels them, so their true gradient is 0, and autograd's ~1e-8 of
    rounding would become an lr-sized Adam step.  They are left out of
    `autograd.grad`, which also skips their reduction.  Weight decay still
    reaches them in the optimizer, as in `cvad_tpu`'s optax chain."""
    # and exactly zero for the parameters the model declares unread by the
    # loss (`zero_grad_params`: family A's structure_params), as in
    # `cvad_tpu`; any other parameter cut off from the loss raises
    zero = set(bn_absorbed_biases(model)) | set(
        getattr(model, "zero_grad_params", ()))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = iter(torch.autograd.grad(
        loss, [p for n, p in named if n not in zero]))
    return [torch.zeros_like(p) if n in zero else next(grads)
            for n, p in named]


def _family_b_task(cfg: ExperimentConfig, mesh: Mesh) -> Task:
    model_cfg: FamilyBConfig = cfg.model
    if cfg.train.dtype != "float32" and model_cfg.dtype == "float32":
        model_cfg = model_cfg.replace(dtype=cfg.train.dtype)
    tx = build_optimizer(cfg.optim)
    loss_cfg = cfg.loss
    clamp = cfg.data.normalize_clamp

    def init_state(seed: int, device=None) -> TrainState:
        """The reference's initialisation from `seed` and an empty bank, on
        CUDA unless `device` says 'cpu'."""
        model = MemoryVideoAutoEncoder(model_cfg, seed=seed)
        return _new_state(model, tx, device, mesh)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   seed: int, gen: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on the normal clips; updates `state` in place (the
        parameters and Adam under the NaN guard, the BatchNorm statistics
        and the bank whatever the guard says; the bank is copied into the
        model's buffers) and returns it with the step's metrics as 0-d
        device tensors.  `seed` and `gen` are unused: the step draws
        nothing."""
        model = state.model
        x = prep_frames(batch["clips"], clamp)  # (B, T, C, H, W)
        b, t = x.shape[:2]
        valid = batch.get("valid")
        # data-side moments of the sufficient-statistics loss:
        # E_t[(f - x_t)^2] = f^2 - 2 f x_bar + E_t[x^2], per pixel
        x_mean = x.mean(1)
        x_sqmean = (x * x).mean((1, 2, 3, 4))
        normal = (batch["labels"] == 0).float()
        if valid is not None:
            normal = normal * valid
        normal = gather_rows(normal, mesh)  # the global batch's, in order
        n_normal = normal.sum()
        bank = model.memory_bank()
        with card_numerics():
            out = model.train().folded_forward(
                x.reshape((b * t,) + x.shape[2:]), None, t=t, valid=valid)
            frame = torch.clamp(out["recon_frame"], 1e-8, 1 - 1e-8)
            fm = (frame * frame).mean((1, 2, 3))
            fx = (frame * x_mean).mean((1, 2, 3))
            err = gather(fm - 2.0 * fx + x_sqmean, mesh.data)
            loss = (err * normal).sum() / torch.clamp(n_normal, min=1.0)
            loss = loss * loss_cfg.b_recon_weight
            grads = stop_bn_absorbed_biases(model, loss)
        model.set_memory_bank(update_memory_masked(
            bank, gather(out["sequence_feature"].detach(), mesh.data),
            normal))
        state = _apply_updates(state, tx, grads, loss.detach(), mesh)
        return state, {"loss": loss.detach(), "n_normal": n_normal}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Per-sample combined score 0.7 recon MSE + 0.3 memory distance
        (K3), its parts, the labels, and the per-sample loss."""
        x = prep_frames(batch["clips"], clamp)
        with card_numerics():
            out = state.model.eval()(x)
        recon_err = ((out["reconstructed"] - x) ** 2).mean((1, 2, 3, 4))
        mem = out["anomaly_score"]
        combined = (loss_cfg.b_score_recon * recon_err
                    + loss_cfg.b_score_memory * mem)
        return _gather_out({"predictions": combined,
                            "recon_errors": recon_err, "memory_scores": mem,
                            "labels": batch["labels"], "loss": recon_err},
                           batch, mesh)

    return Task(model_cfg, tx, init_state, train_step, eval_step)


def _family_c_task(cfg: ExperimentConfig, mesh: Mesh) -> Task:
    model_cfg: FamilyCConfig = cfg.model
    if cfg.train.dtype != "float32" and model_cfg.dtype == "float32":
        model_cfg = model_cfg.replace(dtype=cfg.train.dtype)
    tx = build_optimizer(cfg.optim)
    clamp = cfg.data.normalize_clamp

    def init_state(seed: int, device=None) -> TrainState:
        """The reference's initialisation from `seed`, on CUDA unless
        `device` says 'cpu'."""
        return _new_state(Simple3DCNNDetector(model_cfg, seed=seed), tx,
                          device, mesh)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   seed: int, gen: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step of the BCE over the batch's valid clips (the
        BatchNorm statistics over them too); updates `state` in place.
        `gen` as in family D's step."""
        model = state.model
        clips = prep_clips(batch["clips"], clamp)
        valid = batch.get("valid")
        if gen is None:
            gen = _generator(clips.device, seed, state.step)
        draws = RowDraws(gen, *mesh.rows(clips.shape[0]))
        with card_numerics():
            scores = model.train()(clips, generator=draws, valid=valid)
            loss = _masked_mean_1d(binary_cross_entropy(
                gather(scores.reshape(-1), mesh.data),
                gather_rows(batch["labels"].float(), mesh)),
                gather_rows(valid, mesh))
            grads = stop_bn_absorbed_biases(model, loss)
        state = _apply_updates(state, tx, grads, loss.detach(), mesh)
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Per-clip scores, the labels and the per-clip BCE."""
        clips = prep_clips(batch["clips"], clamp)
        with card_numerics():
            scores = state.model.eval()(clips).reshape(-1)
        labels = batch["labels"].float()
        return _gather_out({"predictions": scores, "labels": labels,
                            "loss": binary_cross_entropy(scores, labels)},
                           batch, mesh)

    return Task(model_cfg, tx, init_state, train_step, eval_step)


def _family_a_task(cfg: ExperimentConfig, mesh: Mesh) -> Task:
    model_cfg: FamilyAConfig = cfg.model
    if cfg.train.dtype != "float32" and model_cfg.dtype == "float32":
        model_cfg = model_cfg.replace(dtype=cfg.train.dtype)
    tx = build_optimizer(cfg.optim)
    loss_cfg = cfg.loss
    clamp = cfg.data.normalize_clamp
    channels = cfg.data.channels

    def init_state(seed: int, device=None) -> TrainState:
        """`cvad_tpu`'s initialisation from `seed` for `data.channels`
        input channels, the stem frozen where ``freeze_stem`` says so, on
        CUDA unless `device` says 'cpu'."""
        return _new_state(CausalPipelineDetector(model_cfg, channels,
                                                 seed=seed), tx, device, mesh)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   seed: int, gen: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step of `family_a_loss`; updates `state` in place (the
        trainable parameters and Adam under the NaN guard, the BatchNorm
        statistics whatever it says).  `gen` as in family D's step."""
        model = state.model
        frames = prep_frames(batch["clips"], clamp)  # (B, T, C, H, W)
        valid = batch.get("valid")
        if gen is None:
            gen = _generator(frames.device, seed, state.step)
        draws = RowDraws(gen, *mesh.rows(frames.shape[0]))
        with card_numerics():
            out = model.train()(frames, generator=draws, valid=valid)
            out = {k: gather(out[k], mesh.data) for k in LOSS_OUTPUTS_A}
            loss, comps = family_a_loss(
                out, gather_rows(batch["labels"], mesh), loss_cfg,
                valid=gather_rows(valid, mesh))
            grads = stop_bn_absorbed_biases(model, loss)
        state = _apply_updates(state, tx, grads, loss.detach(), mesh)
        return state, {"loss": loss.detach(),
                       **{k: v.detach() for k, v in comps.items()}}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The blended scores, the causal scores, the direct softmax, the
        adjacency and the labels."""
        frames = prep_frames(batch["clips"], clamp)
        with card_numerics():
            out = state.model.eval()(frames)
        return _gather_out({"predictions": out["anomaly_scores"],
                            "causal_scores": out["causal_anomaly_scores"],
                            "direct_predictions": out["direct_predictions"],
                            "causal_graphs": out["adjacency_matrices"],
                            "labels": batch["labels"].float()}, batch, mesh)

    return Task(model_cfg, tx, init_state, train_step, eval_step)


# the outputs of family A's model that its loss reads
LOSS_OUTPUTS_A = ("anomaly_scores", "direct_predictions",
                  "causal_anomaly_scores", "kl_losses")

TASKS = {"d": _family_d_task, "c": _family_c_task, "b": _family_b_task,
         "a": _family_a_task}


def build_task(cfg: ExperimentConfig, mesh: Optional[Mesh] = None) -> Task:
    """The task of the config's model family (D, B, C or A) over `mesh`
    (the trivial 1 x 1 mesh by default).  Family E scores only:
    `cvad_tpu` has no train task for it, nor has the port.  Only family D
    shards clips along T; the others raise on a time axis."""
    family = family_of(cfg.model)
    if family not in TASKS:
        raise NotImplementedError(
            f"family {family.upper()} has no train task; it scores only "
            f"(make_score_fn({family!r}, ...))")
    mesh = mesh or single_mesh()
    if family != "d" and mesh.time.size > 1:
        raise ValueError(
            f"family {family.upper()} does not shard clips along T: "
            "parallel.temporal_axis > 1 runs family D only")
    return TASKS[family](cfg, mesh)
