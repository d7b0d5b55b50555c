"""Train and eval steps of the three model families.

Counterpart of the single-device half of the JAX package's
``train/steps.py`` (``make_optimizer``, ``generator_step_body``,
``make_generator_eval_step``, ``aggregate_generator_eval``,
``forecaster_step_body``, ``gan_step_body``, ``make_forecaster_eval_step``,
``aggregate_epoch_metrics``, ``aggregate_sequence_eval``):
- the Generator's loss is the four-term ``combined_loss`` at the scale the
  shapes give (pred width / input width, as the JAX step computes it); its
  eval step returns sums for exact aggregation over wrap-padded batches;
- the forecaster's loss is L1 of the scheduled-sampling rollout against
  the targets; a PredRNN (family predrnn) trains through the same step on
  its own loss (``PredRNN.loss``: the MSE of every step's prediction plus
  the weighted decoupling loss), the draws its [T_in + T_out - 2, B]
  reverse-scheduled-sampling masks;
- the update is clip-by-global-norm then Adam moments, with the LR passed
  per step: ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` with ``lr``
  set in its ``param_groups`` each step, and the clip written by hand to
  optax's formula (scale by max_norm / norm only when norm >= max_norm;
  ``clip_grad_norm_`` divides by norm + 1e-6);
- the NaN-skip decides on ``isfinite(loss)`` alone, as the JAX step does: a
  non-finite loss runs neither the clip nor ``Adam.step``, so the params and
  Adam's state (its own ``step`` included) stay as they were, while the
  state's step count still advances, as ``TrainState.step`` does.

The GAN step (``gan_train_step``) updates D on (real, detached fake), then G
against the updated D, each with its own clip, Adam and NaN-skip, in the
JAX package's two structures (``impl``): "default" runs the generator twice
(once under ``no_grad`` for the D update, once with gradients for G's);
"vjp" runs it once, keeps its graph across the D update and takes G's
gradient through it. G's gradient is ``torch.autograd.grad`` with respect
to G's parameters, so the G loss leaves nothing in D's ``.grad``.

The scheduled-sampling draws are an argument (``teacher_draws`` [steps, B]
bool; the trainer draws them from a ``torch.Generator``): ``jax.random``
streams cannot be replayed in torch, so a test passes JAX's own draws.

Parallel training: every train step takes ``group`` (None: one process), as
the JAX step bodies take ``axis_name``, so one body owns the loss, the
NaN-skip and the update on every path. The step reads it as
``parallel.mesh.MeshGroups`` (``as_groups``): data parallelism alone is
(world, None, world), and a bare process group means data parallelism over
it (the trainers bind ``train_group``'s; ``parallel/train_parallel.py``
names the bound steps as the JAX package does).
Under a group each rank runs the step on its block of the global batch and
- the finite-loss decision is global (``_global_ok``: an all-reduce of the
  ok flag with MIN, still one host decision; GAN: one for D, one for G), so
  a non-finite loss on any rank skips the update on every rank, and the
  replicas stay bit-equal; a skipped update reduces nothing;
- the gradients are averaged over the ranks in one flat buffer before the
  clip and Adam (``_reduced_grads``: SUM then a division by the world
  size, as ``pmean``; gloo has no AVG); every sum over the ranks keeps its
  dtype (``_all_reduce_sum``: one flat buffer a dtype);
- the metrics are averaged over the ranks (``_mean_over``);
- the Generator's point term scales its local weighted-error sum by
  ``world / global count`` (the count's all-reduce carries no gradient),
  and its station RMSE is ``sqrt(sum se / sum count)`` over the ranks
  (``steps.py:136-150`` of the JAX package): the mean over ranks of the
  local losses and gradients is then the global batch's. Every other loss
  is a per-sample mean over equal blocks, whose mean over ranks is already
  the global one.
Explicit collectives, not ``DistributedDataParallel``: they are what
``pmean`` is, and they keep the one body.

Tensor parallelism (``parallel/``): ``MeshGroups`` then has a model
group, and the model's cells hold their shards (parameters marked ``tp_sharded``). Each rank of a model
group runs the step on its data replica's block and computes the same loss
(the cells' outputs are gathered every step and the head is replicated), so
- the finite-loss decision and the metrics run over the data group alone
  (with one data replica: none);
- the shards' gradients are averaged over the data group, the replicated
  parameters' (the head, a GAN's discriminator) over every rank: equal on
  the ranks of a model group already, their mean keeps the replicas
  bit-equal;
- the clip's global norm is the whole logical gradient's: the squared norms
  of the shards summed over the model group, each replicated gradient
  counted once (``clip_by_global_norm_``).

Tracing (``utils.profiling``): each train step is the top-level span
``plcg.train.step``, with ``train.forward``, ``train.backward`` and
``train.update`` (``_adam_update``: the gradients' reduction, the clip and
Adam) inside it, and every host sync of a step is counted (``host_syncs``)
and spanned as ``plcg.sync.<site>``: ``finite_check`` (``_global_ok``),
``loss_value`` (the forecaster's loss) and ``metrics`` (the Generator's and
the GAN's metrics). Each step's docstring says what each sync waits for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..losses import (combined_loss, conservation_loss, contingency_counts,
                      discriminator_loss, gan_generator_loss, gradient_loss,
                      point_supervision_sums, safe_ratio,
                      scores_from_counts, sharpness_sums, ssim_per_sample,
                      station_sq_err_sums, temporal_consistency_loss)
from ..parallel.mesh import MeshGroups, as_groups
from ..utils.profiling import host_sync, span

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    """The port's ``TrainState(params, opt_state, step)``: the model holds the
    params, the optimizer the Adam moments, ``step`` counts train steps
    (skipped ones included)."""
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int = 0


def make_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """Adam moments with optax's ``scale_by_adam`` defaults; the LR is set
    per step and the clip runs before it (``forecaster_train_step``)."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None,
                         model_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g -> g / norm * max_norm when the
    global norm >= max_norm, else unchanged. Returns the norm (a tensor: no
    host sync). The norm is the whole model's: the squared norms of the
    shards (``sharded`` marks them) summed over ``model_group`` (one
    all-reduce under tensor parallelism), plus the replicated gradients',
    each counted once."""
    sharded = sharded or [False] * len(grads)
    sq = [torch.linalg.vector_norm(g).square() for g in grads]
    shard_sq = sum((q for q, s in zip(sq, sharded) if s),
                   torch.zeros((), device=sq[0].device)).reshape(1)
    if model_group is not None and any(sharded):
        dist.all_reduce(shard_sq, group=model_group)
    norm = torch.sqrt(sum((q for q, s in zip(sq, sharded) if not s),
                          shard_sq[0]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _global_ok(total: torch.Tensor, groups: MeshGroups) -> bool:
    """Whether ``total`` is finite; on every rank of the data group (an
    all-reduce of the flags with MIN), so that all ranks take one
    decision. The loss is the same on the ranks of a model group.

    One host sync, ``finite_check``: reading the flag waits for all the
    work queued before it on the stream, not for the loss alone. The train
    steps call this after queueing the backward, so the host waits for the
    forward and the backward (and, under a group, for the slowest rank's)."""
    ok = torch.isfinite(total.detach()).to(torch.float32).reshape(1)
    if groups.data is not None:
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=groups.data)
    with host_sync("finite_check"):
        return bool(ok)


def _all_reduce_sum(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """The sums over the ranks of ``tensors``, in their own dtypes (integer
    counts stay exact), through one flat buffer per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, f in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = f.view_as(tensors[i])
    return out


def _reduced_grads(grads: Sequence[torch.Tensor], groups: MeshGroups,
                   sharded: Sequence[bool]) -> List[torch.Tensor]:
    """``grads`` averaged as ``pmean``: the shards (``sharded``) over the
    data group, the replicated gradients over every rank (data parallelism
    alone: every gradient over the world, one flat sum a dtype)."""
    out = list(grads)
    for shard, grp in ((True, groups.data), (False, groups.every)):
        idx = [i for i, s in enumerate(sharded) if s == shard]
        if grp is None or not idx:
            continue
        world = _world(grp)
        for i, g in zip(idx, _all_reduce_sum([grads[i] for i in idx], grp)):
            out[i] = g.div_(world)
    return out


def _mean_over(values: torch.Tensor, groups: MeshGroups) -> torch.Tensor:
    """A float32 vector of metrics averaged over the data group."""
    if groups.data is None:
        return values
    return _all_reduce_sum([values], groups.data)[0] / _world(groups.data)


def sum_over_ranks(metrics: Dict[str, tuple], group) -> Dict[str, tuple]:
    """An eval step's {metric: (sum, weight)} summed over the ranks of the
    data group of ``group`` (``as_groups``; unchanged without one), one
    collective a dtype: each rank's sums cover its block of the batch, so
    the totals are the global batch's; the int64 contingency counts are
    summed as int64."""
    data = as_groups(group).data
    if data is None:
        return metrics
    keys = list(metrics)
    summed = _all_reduce_sum([t for k in keys for t in metrics[k]], data)
    return {k: (summed[2 * i], summed[2 * i + 1]) for i, k in enumerate(keys)}


def _adam_update(optimizer, params, grads, lr: float, grad_clip_norm: float,
                 groups: MeshGroups) -> None:
    """Average ``grads`` over ``groups`` (``_reduced_grads``), clip them by
    their global norm (optax's rule), then one Adam step of ``params`` at
    ``lr``; leaves no ``.grad`` behind. The span ``plcg.train.update``
    while tracing."""
    with span("train.update"):
        sharded = [getattr(p, "tp_sharded", False) for p in params]
        grads = _reduced_grads(grads, groups, sharded)
        clip_by_global_norm_(grads, grad_clip_norm, sharded, groups.model)
        for p, g in zip(params, grads):
            p.grad = g
        for pg in optimizer.param_groups:
            pg["lr"] = float(lr)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)


# ---------------------------------------------------------------- Generator

LOSS_KEYS = ("lambda_point", "lambda_conserve", "lambda_smooth",
             "lambda_temporal", "use_weighted_loss", "weight_strategy")


def loss_config(training_config) -> Dict:
    """The combined loss's settings from a ``TrainingConfig``."""
    return {k: getattr(training_config, k) for k in LOSS_KEYS}


def generator_loss(model, batch, loss_cfg: Dict, group=None):
    """(total, parts, pred, scale) of the Generator on batch = (rain_lr
    [B,T,1,H,W], dem, lu, s_coords, s_values). The point term is world
    times this rank's weighted-error sum over the count of every rank (the
    count's all-reduce carries no gradient), so that under ``group`` the
    mean over ranks of the totals (and of their gradients) is the global
    batch's loss; in one process it is the batch's point loss."""
    rain_lr, dem, lu, s_coords, s_values = batch
    pred = model(rain_lr, dem, lu)
    scale = pred.shape[-2] / rain_lr.shape[-2]
    p_num, p_cnt = point_supervision_sums(
        pred, s_coords, s_values, scale, loss_cfg["use_weighted_loss"],
        loss_cfg["weight_strategy"])
    if group is not None:
        p_cnt = _all_reduce_sum([p_cnt.detach()], group)[0]
    total, parts = combined_loss(
        pred, rain_lr, s_coords, s_values, scale,
        loss_cfg["lambda_point"], loss_cfg["lambda_conserve"],
        loss_cfg["lambda_smooth"], loss_cfg["lambda_temporal"],
        point=_world(group) * safe_ratio(p_num, p_cnt))
    return total, parts, pred, scale


def generator_train_step(state: TrainState, batch, lr: float, loss_cfg: Dict,
                         grad_clip_norm: float = 0.5, group=None
                         ) -> Dict[str, float]:
    """One update of ``state`` in place on batch = (rain_lr, dem, lu,
    s_coords, s_values): combined loss -> NaN-skip -> clip -> Adam at
    ``lr``. Returns {"total", "rmse" (station RMSE of this batch),
    "skipped", "point", "conserve", "smooth", "temporal"}, as the JAX
    step's metrics. Under ``group`` (data parallel, module docstring)
    ``batch`` is this rank's block of the global batch, and the update and
    the metrics are the global batch's.

    Two host syncs: ``finite_check``, the finite-loss decision, queued
    after the backward, so the host waits for the forward and the backward;
    and ``metrics``, the metrics read to the host, queued after Adam and
    the station RMSE, so the host waits for the whole step."""
    with span("train.step"):
        group = as_groups(group)
        params = list(state.model.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            total, parts, pred, scale = generator_loss(
                state.model, batch, loss_cfg, group.data)
        with span("train.backward"):
            total.backward()
        ok = _global_ok(total, group)
        if ok:
            _adam_update(state.optimizer, params, [p.grad for p in params],
                         lr, grad_clip_norm, group)
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        with torch.no_grad():
            se, cnt = station_sq_err_sums(pred, batch[3], batch[4], scale)
            if group.data is not None:
                se, cnt = _all_reduce_sum([se, cnt], group.data)
            rmse = torch.where(cnt > 0, torch.sqrt(se / cnt.clamp(min=1)),
                               0.0)
        names = ("total", "rmse", *parts)
        values = _mean_over(torch.stack([t.detach().float() for t in (
            total, rmse, *parts.values())]), group)
        with host_sync("metrics"):
            values = values.tolist()
        return {**dict(zip(names, values)), "skipped": int(not ok)}


@torch.no_grad()
def generator_eval_step(model, batch, n_valid: int, loss_cfg: Dict,
                        row0: int = 0) -> Dict[str, tuple]:
    """{metric: (sum, weight)} of the Generator on one batch; rows with
    index >= n_valid (wrap-padding) carry weight 0. ``row0`` is the global
    index of the batch's first row (a rank's block under data
    parallelism; ``sum_over_ranks`` then totals the sums). Values stay on
    the device; ``aggregate_generator_eval`` fetches them."""
    rain_lr, dem, lu, s_coords, s_values = batch
    b = rain_lr.shape[0]
    valid = torch.arange(row0, row0 + b, device=rain_lr.device) < n_valid
    nv = valid.float().sum()
    pred = model(rain_lr, dem, lu)
    scale = pred.shape[-2] / rain_lr.shape[-2]
    return {
        "point": point_supervision_sums(
            pred, s_coords, s_values, scale, loss_cfg["use_weighted_loss"],
            loss_cfg["weight_strategy"], batch_mask=valid),
        "conserve": (conservation_loss(pred, rain_lr, valid) * nv, nv),
        "smooth": (gradient_loss(pred, valid) * nv, nv),
        "temporal": (temporal_consistency_loss(pred, valid) * nv, nv),
        "se": station_sq_err_sums(pred, s_coords, s_values, scale,
                                  batch_mask=valid),
    }


def aggregate_generator_eval(metric_batches, loss_cfg: Dict
                             ) -> Optional[Dict[str, float]]:
    """Exact aggregation of Generator eval sums over batches: {"loss",
    "rmse", "point", "conserve", "smooth", "temporal"}."""
    if not metric_batches:
        return None
    metric_batches = _to_host(list(metric_batches))   # one transfer
    keys = metric_batches[0].keys()
    num = {k: sum(float(m[k][0]) for m in metric_batches) for k in keys}
    wt = {k: sum(float(m[k][1]) for m in metric_batches) for k in keys}
    comp = {k: (num[k] / wt[k] if wt[k] > 0 else 0.0)
            for k in ("point", "conserve", "smooth", "temporal")}
    rmse = (num["se"] / wt["se"]) ** 0.5 if wt["se"] > 0 else 0.0
    total = (loss_cfg["lambda_point"] * comp["point"]
             + loss_cfg["lambda_conserve"] * comp["conserve"]
             + loss_cfg["lambda_smooth"] * comp["smooth"]
             + loss_cfg["lambda_temporal"] * comp["temporal"])
    return {"loss": total, "rmse": rmse, **comp}


# --------------------------------------------------------------- forecaster

def forecaster_loss(model, inputs, targets, teacher_draws=None):
    """(loss, predictions): the model's own ``loss`` (``ConvLSTMForecaster``:
    L1 of the rollout with scheduled sampling; ``PredRNN``: MSE plus the
    weighted decoupling loss, ``teacher_draws`` its masks)."""
    return model.loss(inputs, targets, teacher_draws)


def forecaster_train_step(state: TrainState, batch, lr: float,
                          teacher_draws: Optional[torch.Tensor] = None,
                          grad_clip_norm: float = 0.5, group=None
                          ) -> Dict[str, float]:
    """One update of ``state`` in place on batch = (inputs [B,T_in,C,H,W],
    targets [B,T_out,C,H,W]); returns {"total": loss, "skipped": 0 or 1}.
    Under ``group`` (data parallel, module docstring) ``batch`` and
    ``teacher_draws`` are this rank's block of the global batch's.

    Two host syncs: ``finite_check``, the finite-loss decision, queued
    after the backward, so the host waits for the forward and the backward;
    and ``loss_value``, the loss read to the host, queued after Adam, so the
    host waits for the whole step and never runs ahead into the next
    step's forward."""
    with span("train.step"):
        group = as_groups(group)
        inputs, targets = batch
        params = list(state.model.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            total, _ = forecaster_loss(state.model, inputs, targets,
                                       teacher_draws)
        with span("train.backward"):
            total.backward()
        ok = _global_ok(total, group)
        if ok:
            _adam_update(state.optimizer, params, [p.grad for p in params],
                         lr, grad_clip_norm, group)
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        total = _mean_over(total.detach().float().reshape(1), group)
        with host_sync("loss_value"):
            total = float(total)
        return {"total": total, "skipped": int(not ok)}


# ---------------------------------------------------------------------- GAN

@dataclass
class GANTrainState:
    """The port's ``GANTrainState``: the generator and discriminator modules
    hold the params, one Adam each holds the moments, ``step`` counts GAN
    steps (skipped ones included)."""
    gen: torch.nn.Module
    disc: torch.nn.Module
    gen_optimizer: torch.optim.Adam
    disc_optimizer: torch.optim.Adam
    step: int = 0


GAN_IMPLS = ("default", "vjp")


def gan_d_loss(disc, targets, fake, label_smoothing: float = 0.0):
    """(D total, {"d_real", "d_fake"}) on the real targets and ``fake``
    (which the caller detaches)."""
    return discriminator_loss(disc(targets), disc(fake), label_smoothing)


def gan_g_loss(disc, fake, targets, lambda_adv: float = 0.001,
               lambda_l1: float = 1.0):
    """(G total, {"g_adv", "g_l1"}) of ``fake`` against ``disc``."""
    return gan_generator_loss(disc(fake), fake, targets, lambda_adv,
                              lambda_l1)


def gan_train_step(state: GANTrainState, batch, g_lr: float, d_lr: float,
                   teacher_draws: Optional[torch.Tensor] = None,
                   lambda_adv: float = 0.001, lambda_l1: float = 1.0,
                   label_smoothing: float = 0.0, grad_clip_norm: float = 0.5,
                   impl: str = "default", group=None) -> Dict[str, float]:
    """One GAN step of ``state`` in place on batch = (inputs, targets):
    G forward -> D update on (real, detached fake) -> G update against the
    updated D. Each of D and G skips its own update when its loss is not
    finite (params and Adam state, Adam's ``step`` included, unchanged).
    Returns {"d_total", "g_total", "skipped" (D or G skipped), "d_real",
    "d_fake", "g_adv", "g_l1"}.

    ``impl`` "default": the G forward for the D update runs under
    ``no_grad`` (on the kernel path: K1 without z), then a second forward
    with gradients (K1 with z) and the same teacher draws. "vjp": one
    forward with gradients; D reads ``fake.detach()``, and G's gradient
    goes back through that forward's graph. Under ``group`` (data
    parallel, module docstring) each decision is global and each side's
    gradients are averaged over the ranks.

    Three host syncs: D's ``finite_check``, queued after D's backward, so
    the host waits for G's forward and D's forward and backward; G's
    ``finite_check``, queued after G's backward, so it waits for D's
    update and G's forward and backward; and ``metrics``, queued after G's
    update, so it waits for the whole step. Spans: ``train.forward`` (G's
    forward with D's loss; then G's loss, after a second G forward under
    "default"), ``train.backward`` (each side's gradient) and
    ``train.update`` twice, D's then G's."""
    if impl not in GAN_IMPLS:
        raise ValueError(f"Unknown gan_step_impl: {impl!r} (valid: "
                         f"{', '.join(GAN_IMPLS)})")
    with span("train.step"):
        group = as_groups(group)
        inputs, targets = batch
        gen, disc = state.gen, state.disc
        g_params, d_params = list(gen.parameters()), list(disc.parameters())
        with span("train.forward"):
            if impl == "vjp":
                fake = gen(inputs, targets, teacher_draws)
            else:
                with torch.no_grad():
                    fake = gen(inputs, targets, teacher_draws)
            d_total, d_parts = gan_d_loss(disc, targets, fake.detach(),
                                          label_smoothing)
        with span("train.backward"):
            d_grads = list(torch.autograd.grad(d_total, d_params))
        d_ok = _global_ok(d_total, group)
        if d_ok:
            _adam_update(state.disc_optimizer, d_params, d_grads, d_lr,
                         grad_clip_norm, group)
        del d_grads

        with span("train.forward"):
            if impl == "default":
                fake = gen(inputs, targets, teacher_draws)
            g_total, g_parts = gan_g_loss(disc, fake, targets, lambda_adv,
                                          lambda_l1)
        with span("train.backward"):
            g_grads = list(torch.autograd.grad(g_total, g_params))
        g_ok = _global_ok(g_total, group)
        if g_ok:
            _adam_update(state.gen_optimizer, g_params, g_grads, g_lr,
                         grad_clip_norm, group)
        state.step += 1
        names = ("d_total", "g_total", *d_parts, *g_parts)
        values = _mean_over(torch.stack([t.detach().float() for t in (
            d_total, g_total, *d_parts.values(), *g_parts.values())]), group)
        with host_sync("metrics"):
            values = values.tolist()
        return {**dict(zip(names, values)),
                "skipped": int(not (d_ok and g_ok))}


@torch.no_grad()
def forecaster_eval_step(model, batch, n_valid: int,
                         score_thresholds: Optional[Sequence[float]] = None,
                         sharpness: bool = False, row0: int = 0
                         ) -> Dict[str, tuple]:
    """{metric: (sum, weight)} of a free-running rollout on one batch; rows
    with index >= n_valid (wrap-padding) carry weight 0. Contingency counts
    ride along raw (``counts@<th>``) so the host forms scores from global
    counts. ``row0`` is the global index of the batch's first row (a rank's
    block under data parallelism; ``sum_over_ranks`` then totals the sums).
    Values stay on the device; ``aggregate_sequence_eval`` fetches them."""
    inputs, targets = batch
    b = inputs.shape[0]
    valid = torch.arange(row0, row0 + b, device=inputs.device) < n_valid
    vm = valid.float()
    nv = vm.sum()
    pred = model(inputs)
    l1_ps = (pred - targets).abs().reshape(b, -1).mean(dim=1)
    ssim_ps = ssim_per_sample(pred, targets)
    out = {"l1": ((l1_ps * vm).sum(), nv), "ssim": ((ssim_ps * vm).sum(), nv)}
    for th in (score_thresholds or ()):
        counts = contingency_counts(pred, targets, th, valid)
        out[f"counts@{th:g}"] = (torch.stack(counts), nv)
    if sharpness:
        out.update(sharpness_sums(pred, targets, valid))
    return out


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def aggregate_epoch_metrics(metrics_acc: List[Dict]) -> Dict[str, float]:
    """Epoch averages over per-step metrics, leaving out NaN-skipped steps;
    an epoch whose every step was skipped averages to NaN (never a new
    best, a bad plateau epoch), as in the JAX package."""
    stacked = {k: np.asarray([float(m[k]) for m in metrics_acc])
               for k in metrics_acc[0]}
    skipped = int(stacked["skipped"].sum())
    keep = stacked["skipped"] < 1
    if skipped:
        print(f"NaN guard: skipped {skipped} batch updates this epoch")
    avg = {k: float(v[keep].mean()) if keep.any() else float("nan")
           for k, v in stacked.items()}
    avg["skipped"] = float(skipped)
    return avg


def aggregate_sequence_eval(metric_batches) -> Optional[Dict[str, float]]:
    """Exact aggregation of eval sums over batches: masked means of l1 and
    ssim, POD/FAR/CSI/HSS from the global contingency counts, sharpness
    ratios of the global means. Key names as in the JAX package."""
    if not metric_batches:
        return None
    metric_batches = _to_host(list(metric_batches))   # one transfer
    out: Dict[str, float] = {}
    for k in metric_batches[0]:
        num = sum(np.asarray(m[k][0], np.float64) for m in metric_batches)
        wt = sum(float(m[k][1]) for m in metric_batches)
        if k.startswith("counts@"):
            hits, miss, fa, cn = num
            th = k.split("@", 1)[1]
            out.update({f"{s}@{th}": float(v) for s, v in
                        scores_from_counts(hits, fa, miss, cn).items()})
        else:
            out[k] = float(num) / wt if wt > 0 else 0.0
    for name in ("hf", "gm"):
        p = out.pop(f"sharp_{name}_pred", None)
        t = out.pop(f"sharp_{name}_true", None)
        if p is not None:
            out[f"sharp_{name}_ratio"] = p / t if t else float("nan")
    return out
