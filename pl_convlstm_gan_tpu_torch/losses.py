"""Losses and eval metrics of the three model families, in plain PyTorch.

Copies of the JAX package's ``losses/adversarial.py`` (``l1_loss``,
``l2_loss`` and the GAN losses: ``bce_with_logits`` in its log-sum-exp form,
``discriminator_loss`` with one-sided label smoothing, the non-saturating
``generator_adversarial_loss``, ``gan_generator_loss``; the part names
``d_real``, ``d_fake``, ``g_adv``, ``g_l1`` as in JAX),
``losses/ssim.py``, ``losses/metrics.py`` and ``losses/sharpness.py``, with
the same formulas, clamps and masks:

- ``ssim`` / ``ssim_per_sample``: Wang et al. 2004 with an 11x11 Gaussian
  window (sigma 1.5, K1 0.01, K2 0.03, data range 1 by default), separable
  VALID blur, variance clamped at 0 and covariance at +-sqrt(var_p var_t);
  frames smaller than the window use the largest odd size that fits;
- ``contingency_counts`` / ``scores_from_counts`` / ``categorical_scores``
  / ``nowcast_scores``: hits, misses, false alarms and correct negatives
  at a threshold, and POD/FAR/CSI/HSS from them (integer counts; the host
  turns global sums into scores);
- ``sharpness_sums``: high-frequency spectral power fraction and mean
  gradient magnitude, as (sum, weight) pairs for exact global ratios;
- the Generator's ``combined_loss`` and its terms, with ``CombinedLoss``,
  the reference's class surface over it.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .ops.resize import resize_area


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


# ------------------------------------------------------------------ GAN

def bce_with_logits(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean elementwise binary cross-entropy on logits, in the stable form
    max(x, 0) - x*y + log(1 + exp(-|x|)) (never forms the sigmoid)."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                       label_smoothing: float = 0.0):
    """(0.5 * (BCE(real, 1 - label_smoothing) + BCE(fake, 0)), {"d_real",
    "d_fake"}): one-sided label smoothing on the real targets only."""
    loss_real = bce_with_logits(real_logits, 1.0 - label_smoothing)
    loss_fake = bce_with_logits(fake_logits, 0.0)
    return 0.5 * (loss_real + loss_fake), {"d_real": loss_real,
                                           "d_fake": loss_fake}


def generator_adversarial_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating G loss: BCE(fake, 1)."""
    return bce_with_logits(fake_logits, 1.0)


def gan_generator_loss(fake_logits: torch.Tensor, pred: torch.Tensor,
                       target: torch.Tensor, lambda_adv: float = 0.001,
                       lambda_l1: float = 1.0):
    """(lambda_adv * BCE(fake, 1) + lambda_l1 * L1(pred, target), {"g_adv",
    "g_l1"})."""
    adv = generator_adversarial_loss(fake_logits)
    rec = l1_loss(pred, target)
    return lambda_adv * adv + lambda_l1 * rec, {"g_adv": adv, "g_l1": rec}


# --------------------------------------------------------------------- SSIM

def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable VALID gaussian filter over H, W of [N, 1, H, W]."""
    n = win.shape[0]
    y = F.conv2d(x, win.reshape(1, 1, n, 1))
    return F.conv2d(y, win.reshape(1, 1, 1, n))


def _ssim_map(pred, target, data_range: float, window_size: int,
              sigma: float, k1: float, k2: float):
    """Flattened-leading-dims SSIM map [N, 1, H', W'] (VALID-cropped) of
    [..., H, W] tensors, or of [..., H, W, 1] (a trailing channel of 1)."""
    if pred.shape[-1] == 1 and pred.dim() >= 3:
        pred, target = pred[..., 0], target[..., 0]
    h, w = pred.shape[-2], pred.shape[-1]
    p = pred.reshape(-1, 1, h, w).float()
    t = target.reshape(-1, 1, h, w).float()
    eff = min(window_size, h, w)
    if eff % 2 == 0:
        eff -= 1
    win = torch.from_numpy(_gaussian_kernel(eff, sigma)).to(p.device)
    mu_p = _blur(p, win)
    mu_t = _blur(t, win)
    # variances clamped at 0 and the covariance at the Cauchy-Schwarz bound,
    # as the JAX copy does (f32 cancellation in E[X^2] - E[X]^2)
    mu_pp = torch.clamp(_blur(p * p, win) - mu_p * mu_p, min=0.0)
    mu_tt = torch.clamp(_blur(t * t, win) - mu_t * mu_t, min=0.0)
    mu_pt = _blur(p * t, win) - mu_p * mu_t
    var_prod = mu_pp * mu_tt
    safe_prod = torch.where(var_prod > 0, var_prod, torch.ones_like(var_prod))
    cov_bound = torch.where(var_prod > 0, torch.sqrt(safe_prod),
                            torch.zeros_like(var_prod))
    mu_pt = torch.minimum(torch.maximum(mu_pt, -cov_bound), cov_bound)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (mu_pp + mu_tt + c2)
    return num / den


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over all frames of [..., H, W] tensors."""
    return _ssim_map(pred, target, data_range, window_size, sigma, k1,
                     k2).mean()


def ssim_per_sample(pred: torch.Tensor, target: torch.Tensor,
                    data_range: float = 1.0, window_size: int = 11,
                    sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03) -> torch.Tensor:
    """Per-sample mean SSIM [B] of batch-leading [B, ..., H, W] tensors."""
    b = pred.shape[0]
    return _ssim_map(pred, target, data_range, window_size, sigma, k1,
                     k2).reshape(b, -1).mean(dim=1)


# ------------------------------------------------------ categorical scores

def contingency_counts(pred: torch.Tensor, target: torch.Tensor,
                       threshold: float, batch_mask: torch.Tensor = None):
    """(hits, misses, false_alarms, correct_negatives) at a threshold, over
    the rows of the batch-leading tensors where ``batch_mask`` [B] is true
    (all rows when None); integer sums, exact at any pixel count."""
    p = pred >= threshold
    t = target >= threshold
    stats = (p & t, ~p & t, p & ~t, ~p & ~t)
    if batch_mask is None:
        return tuple(s.sum() for s in stats)
    b = pred.shape[0]
    m = batch_mask.to(torch.int64)
    return tuple((s.reshape(b, -1).sum(dim=1) * m).sum() for s in stats)


def _safe(num, den):
    """num / den where den > 0, else 0 (den >= 0), elementwise on numpy
    values or torch tensors alike."""
    return (den > 0) * num / (den + (den == 0))


def scores_from_counts(a, b, c, d) -> Dict[str, float]:
    """POD/FAR/CSI/HSS from (hits a, false_alarms b, misses c,
    correct_negatives d): host counts when eval aggregates them across
    batches, or float tensors on their device (``categorical_scores``)."""
    pod = _safe(a, a + c)
    far = _safe(b, a + b)
    csi = _safe(a, a + b + c)
    expected = (a + c) * (c + d) + (a + b) * (b + d)
    hss = _safe(2 * (a * d - b * c), expected)
    return {"pod": pod, "far": far, "csi": csi, "hss": hss}


def categorical_scores(pred: torch.Tensor, target: torch.Tensor,
                       threshold: float) -> Dict[str, torch.Tensor]:
    """POD/FAR/CSI/HSS at one threshold over all of pred and target, as
    float32 scalars on their device."""
    a, c, b, d = (x.float() for x in contingency_counts(pred, target,
                                                         threshold))
    return scores_from_counts(a, b, c, d)


def nowcast_scores(pred: torch.Tensor, target: torch.Tensor,
                   thresholds: Sequence[float] = (0.5, 2.0, 5.0, 10.0, 30.0)
                   ) -> Dict[str, torch.Tensor]:
    """``{metric}@{threshold}`` over a set of intensity thresholds."""
    out = {}
    for th in thresholds:
        for k, v in categorical_scores(pred, target, th).items():
            out[f"{k}@{th:g}"] = v
    return out


# ---------------------------------------------------------------- sharpness

def _hf_mask(h: int, w: int, cutoff: float) -> np.ndarray:
    fy = np.fft.fftfreq(h)[:, None] * 2.0
    fx = np.fft.rfftfreq(w)[None, :] * 2.0
    return np.sqrt(fy * fy + fx * fx) > cutoff


def hf_energy_fraction(x: torch.Tensor, cutoff: float = 0.5) -> torch.Tensor:
    """Spectral power fraction above ``cutoff`` x the Nyquist radius, per
    sample of [B, ..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    spec = torch.fft.rfft2(x.float()).abs() ** 2
    mask = torch.from_numpy(_hf_mask(h, w, cutoff).astype(np.float32)).to(
        spec.device)
    b = x.shape[0]
    total = spec.reshape(b, -1, *spec.shape[-2:]).sum(dim=(1, 2, 3))
    hf = (spec * mask).reshape(b, -1, *spec.shape[-2:]).sum(dim=(1, 2, 3))
    return hf / torch.clamp(total, min=1e-12)


def grad_mag_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean forward-difference gradient magnitude per sample."""
    dx = torch.diff(x, dim=-1).abs()
    dy = torch.diff(x, dim=-2).abs()
    b = x.shape[0]
    return 0.5 * (dx.reshape(b, -1).mean(dim=1) + dy.reshape(b, -1).mean(dim=1))


def sharpness_sums(pred: torch.Tensor, target: torch.Tensor,
                   valid_mask: torch.Tensor) -> dict:
    """(sum, weight) pairs of the sharpness measures of pred and target over
    the valid rows; the host forms the ratios of the global means."""
    vm = valid_mask.float()
    nv = vm.sum()
    out = {}
    for name, fn in (("hf", hf_energy_fraction), ("gm", grad_mag_mean)):
        out[f"sharp_{name}_pred"] = ((fn(pred) * vm).sum(), nv)
        out[f"sharp_{name}_true"] = ((fn(target) * vm).sum(), nv)
    return out


# ------------------------------------------------- Generator: CombinedLoss

def compute_sample_weights(rain_values: torch.Tensor,
                           use_weighted_loss: bool = True,
                           weight_strategy: str = "log") -> torch.Tensor:
    """Intensity weights: log 1 + log1p(r); stratified 2/3/5 at >= 10/25/50
    mm, else 1; sqrt 1 + sqrt(r); off (or an unknown strategy) 1."""
    if not use_weighted_loss:
        return torch.ones_like(rain_values)
    if weight_strategy == "log":
        return 1.0 + torch.log1p(rain_values)
    if weight_strategy == "stratified":
        w = torch.ones_like(rain_values)
        w = torch.where(rain_values >= 10, 2.0, w)
        w = torch.where(rain_values >= 25, 3.0, w)
        return torch.where(rain_values >= 50, 5.0, w)
    if weight_strategy == "sqrt":
        return 1.0 + torch.sqrt(rain_values)
    return torch.ones_like(rain_values)


def _station_pixel_indices(coords: torch.Tensor, scale_factor, h: int,
                           w: int):
    """LR station coords [N, 2] -> (rows, cols, valid) at the HR grid:
    (c + 0.5) * s - 0.5 truncated toward zero (a slightly negative value
    maps to 0, kept), then the bounds mask; rows and cols clamped for the
    gather."""
    scaled = ((coords.float() + 0.5) * scale_factor - 0.5).to(torch.int32)
    rows, cols = scaled[:, 0], scaled[:, 1]
    valid = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return rows.clamp(0, h - 1), cols.clamp(0, w - 1), valid


def prepare_station_batch(s_coords: torch.Tensor, s_values: torch.Tensor,
                          batch: int):
    """(coords [N, 2], values [B, T, N]) from coords [N, 2] or [B, N, 2]
    (item 0: the stations are the same across the batch) and values [T, N]
    or [B, T, N]."""
    coords = s_coords[0] if s_coords.dim() == 3 else s_coords
    values = (s_values[None].expand(batch, *s_values.shape)
              if s_values.dim() == 2 else s_values)
    return coords, values


def _stations_pred_obs_mask(pred, s_coords, s_values, scale_factor,
                            batch_mask):
    """(pred at the station pixels [B, T, N], observations with NaN -> 0,
    mask of finite observations inside the grid and valid batch rows)."""
    b, t, _, h, w = pred.shape
    coords, values = prepare_station_batch(s_coords, s_values, b)
    rows, cols, station_valid = _station_pixel_indices(coords, scale_factor,
                                                       h, w)
    flat = pred[:, :, 0].reshape(b, t, h * w)
    pred_at = flat[..., (rows * w + cols).long()]
    mask = (~torch.isnan(values) & station_valid[None, None, :]).to(
        pred_at.dtype)
    if batch_mask is not None:
        mask = mask * batch_mask.to(mask.dtype)[:, None, None]
    return pred_at, torch.nan_to_num(values, nan=0.0), mask


def point_supervision_sums(pred, s_coords, s_values, scale_factor=1.0,
                           use_weighted_loss: bool = True,
                           weight_strategy: str = "log", batch_mask=None):
    """(weighted |error| sum, valid-entry count) at the station pixels."""
    pred_at, obs, mask = _stations_pred_obs_mask(pred, s_coords, s_values,
                                                 scale_factor, batch_mask)
    weights = compute_sample_weights(obs, use_weighted_loss, weight_strategy)
    return ((pred_at - obs).abs() * weights * mask).sum(), mask.sum()


def safe_ratio(num, count):
    """num / count, 0 where count is 0."""
    return torch.where(count > 0, num / count.clamp(min=1), 0.0)


def point_supervision_loss(pred, s_coords, s_values, scale_factor=1.0,
                           use_weighted_loss: bool = True,
                           weight_strategy: str = "log", batch_mask=None):
    """Masked, intensity-weighted L1 at the station pixels (0 when no
    entry is valid)."""
    return safe_ratio(*point_supervision_sums(pred, s_coords, s_values,
                                              scale_factor, use_weighted_loss,
                                              weight_strategy, batch_mask))


def _batch_mean(per_sample: torch.Tensor, batch_mask):
    if batch_mask is None:
        return per_sample.mean()
    m = batch_mask.to(per_sample.dtype)
    return safe_ratio((per_sample * m).sum(), m.sum())


def _per_sample_mean(err: torch.Tensor) -> torch.Tensor:
    return err.reshape(err.shape[0], -1).mean(dim=1)


def conservation_loss(pred, lr_input, batch_mask=None):
    """Mass conservation: pred area-resized to the LR grid, L1 against the
    LR input. pred [B, T, 1, H, W], lr_input [B, T, 1, h, w]."""
    h_lr, w_lr = lr_input.shape[-2:]
    p_lr = resize_area(pred.movedim(2, -1), h_lr, w_lr)
    err = (p_lr - lr_input.movedim(2, -1)).abs()
    return _batch_mean(_per_sample_mean(err), batch_mask)


def gradient_loss(pred, batch_mask=None):
    """Spatial smoothness: mean |dx| + mean |dy|."""
    gx = (pred[..., :, :-1] - pred[..., :, 1:]).abs()
    gy = (pred[..., :-1, :] - pred[..., 1:, :]).abs()
    return (_batch_mean(_per_sample_mean(gx), batch_mask)
            + _batch_mean(_per_sample_mean(gy), batch_mask))


def temporal_consistency_loss(pred, batch_mask=None):
    """Adjacent-step smoothness: mean |pred_t - pred_t+1|."""
    err = (pred[:, :-1] - pred[:, 1:]).abs()
    return _batch_mean(_per_sample_mean(err), batch_mask)


def combined_loss(pred, lr_input, s_coords, s_values, scale_factor=1.0,
                  lambda_point: float = 1.0, lambda_conserve: float = 1.0,
                  lambda_smooth: float = 0.1, lambda_temporal: float = 0.05,
                  use_weighted_loss: bool = True, weight_strategy: str = "log",
                  batch_mask=None, point=None):
    """(lp*point + lc*conserve + ls*smooth + lt*temporal, {"point",
    "conserve", "smooth", "temporal"}). ``point``: the point term when the
    caller forms it from ``point_supervision_sums`` (the train step does,
    over the count of every rank under data parallelism); None computes it
    here."""
    if point is None:
        point = point_supervision_loss(pred, s_coords, s_values, scale_factor,
                                       use_weighted_loss, weight_strategy,
                                       batch_mask)
    parts = {
        "point": point,
        "conserve": conservation_loss(pred, lr_input, batch_mask),
        "smooth": gradient_loss(pred, batch_mask),
        "temporal": temporal_consistency_loss(pred, batch_mask)}
    total = (lambda_point * parts["point"]
             + lambda_conserve * parts["conserve"]
             + lambda_smooth * parts["smooth"]
             + lambda_temporal * parts["temporal"])
    return total, parts


def station_sq_err_sums(pred, s_coords, s_values, scale_factor=1.0,
                        batch_mask=None):
    """(squared-error sum, valid-entry count) at the station pixels: the sum
    form of ``station_rmse`` for exact aggregation over batches."""
    pred_at, obs, mask = _stations_pred_obs_mask(pred, s_coords, s_values,
                                                 scale_factor, batch_mask)
    return ((pred_at - obs).square() * mask).sum(), mask.sum()


def station_rmse(pred, s_coords, s_values, scale_factor=1.0, batch_mask=None):
    """Masked RMSE at the station pixels (0 when no entry is valid)."""
    num, count = station_sq_err_sums(pred, s_coords, s_values, scale_factor,
                                     batch_mask)
    return torch.where(count > 0, torch.sqrt(num / count.clamp(min=1)), 0.0)


class CombinedLoss:
    """The reference's class surface over ``combined_loss``: the weights and
    the weighting set at construction, ``__call__(pred, lr_input, s_coords,
    s_values, scale_factor=1.0) -> (total, parts)``. Stateless."""

    def __init__(self, lambda_point=1.0, lambda_conserve=1.0,
                 lambda_smooth=0.1, lambda_temporal=0.05,
                 use_weighted_loss=True, weight_strategy="log"):
        self.lambda_point = lambda_point
        self.lambda_conserve = lambda_conserve
        self.lambda_smooth = lambda_smooth
        self.lambda_temporal = lambda_temporal
        self.use_weighted_loss = use_weighted_loss
        self.weight_strategy = weight_strategy

    def __call__(self, pred, lr_input, s_coords, s_values, scale_factor=1.0):
        return combined_loss(pred, lr_input, s_coords, s_values, scale_factor,
                             self.lambda_point, self.lambda_conserve,
                             self.lambda_smooth, self.lambda_temporal,
                             self.use_weighted_loss, self.weight_strategy)
