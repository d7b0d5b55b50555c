"""The reference's train step: the loss, its gradients by autograd, the
clip by global norm (scale by max_norm / norm when norm >= max_norm), then
Adam (betas 0.9 / 0.999, eps 1e-8, bias-corrected) at the step's rate.

``TrainState`` is plain tensors, so a step can start from any state,
among them the program's own at a given step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from . import convlstm, generator

BETAS = (0.9, 0.999)
EPS = 1e-8


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    step: int

    @classmethod
    def fresh(cls, params: Dict[str, torch.Tensor]) -> "TrainState":
        return cls({k: v.clone() for k, v in params.items()},
                   {k: torch.zeros_like(v) for k, v in params.items()},
                   {k: torch.zeros_like(v) for k, v in params.items()}, 0)


def loss_fn(family: str, model: dict, loss_cfg: dict, params, batch,
            q: convlstm.Round) -> torch.Tensor:
    if family == "forecaster":
        inputs, targets = batch
        return convlstm.l1(convlstm.forecaster_forward(params, model, inputs,
                                                       q), targets)
    rain_lr, dem, lu, s_coords, s_values = batch
    pred = generator.forward(params, model, rain_lr, dem, lu, q)
    return generator.combined_loss(pred, rain_lr, s_coords, s_values,
                                   loss_cfg)


def train_step(family: str, model: dict, loss_cfg: dict, state: TrainState,
               batch, lr: float, max_norm: float, q: convlstm.Round,
               update: bool = True, rows: Optional[int] = None):
    """One step from ``state``: (loss, clipped gradients, the state after
    the step). ``update`` False leaves the state as it was (a fault).
    ``rows``: the forecaster's batch in blocks of that many rows (its loss
    is a mean over equal blocks), so that the step fits beside its
    activations."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.params.items()}
    names = list(params)
    size = batch[0].shape[0]
    rows = rows if family == "forecaster" and rows else size
    loss, grads = 0.0, None
    for lo in range(0, size, rows):
        part = tuple(t[lo:lo + rows] for t in batch)
        block = loss_fn(family, model, loss_cfg, params, part, q) * (
            part[0].shape[0] / size)
        g = torch.autograd.grad(block, [params[k] for k in names])
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss += float(block.detach())
    with torch.no_grad():
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = 1.0 if float(norm) < max_norm else max_norm / float(norm)
        grads = {k: g * scale for k, g in zip(names, grads)}
        if not update:
            return loss, grads, state
        t = state.step + 1
        b1, b2 = BETAS
        new = TrainState({}, {}, {}, t)
        for k in names:
            m = b1 * state.exp_avg[k] + (1 - b1) * grads[k]
            v = b2 * state.exp_avg_sq[k] + (1 - b2) * grads[k].square()
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            new.params[k] = state.params[k] - lr * m_hat / (v_hat.sqrt() + EPS)
            new.exp_avg[k], new.exp_avg_sq[k] = m, v
    return loss, grads, new
