"""Data-parallel train steps over a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/train_parallel.py``: each step is
the single-process step of ``train/steps.py`` bound to the data group, as
the JAX DP steps are the step bodies built with ``axis_name`` and
``shard_map``ped over the mesh. One body owns the loss, the NaN-skip and the
update on both paths, so they cannot drift: each rank runs the step on its
block of the global batch (``data.batch_iterator`` with ``process_index`` /
``process_count``), the finite-loss decision is global, the gradients are
averaged over the ranks in one flat all-reduce before the clip and Adam,
and the metrics are the global batch's (``train/steps.py``'s docstring).
The replicas start from one state (``parallel.mesh.broadcast_module``) and
stay bit-equal, since every rank applies the same averaged gradients.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch.distributed as dist

from ..train.steps import (forecaster_train_step, gan_train_step,
                           generator_train_step)


def _group(group):
    if not dist.is_initialized():
        raise RuntimeError("a data-parallel step needs an initialised process "
                           "group (parallel.mesh.maybe_init_distributed)")
    return dist.group.WORLD if group is None else group


def make_dp_generator_train_step(loss_cfg: Dict, group=None) -> Callable:
    """step(state, batch, lr, grad_clip_norm=0.5) -> metrics: the Generator
    step over ``group`` (default: the whole world). ``batch`` is this rank's
    block of the global batch, whose stations may hold other NaN patterns
    than the other ranks'; the point term and RMSE use the global counts."""
    return functools.partial(generator_train_step, loss_cfg=loss_cfg,
                             group=_group(group))


def make_dp_forecaster_train_step(group=None) -> Callable:
    """step(state, batch, lr, teacher_draws=None, grad_clip_norm=0.5) ->
    metrics: the forecaster step over ``group``. ``teacher_draws`` are this
    rank's columns of the global batch's draws."""
    return functools.partial(forecaster_train_step, group=_group(group))


def make_dp_gan_train_step(group=None, impl: str = "default",
                           lambda_adv: float = 0.001, lambda_l1: float = 1.0,
                           label_smoothing: float = 0.0) -> Callable:
    """step(state, batch, g_lr, d_lr, teacher_draws=None, grad_clip_norm=0.5)
    -> metrics: the GAN step (``impl`` "default" or "vjp") over ``group``,
    with the D and G decisions global and both sides' gradients
    averaged."""
    return functools.partial(gan_train_step, impl=impl, lambda_adv=lambda_adv,
                             lambda_l1=lambda_l1,
                             label_smoothing=label_smoothing,
                             group=_group(group))
