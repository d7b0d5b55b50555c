"""Losses and eval metrics of the forecaster and GAN families, in plain
PyTorch.

Copies of the JAX package's ``losses/adversarial.py`` (``l1_loss``,
``l2_loss`` and the GAN losses: ``bce_with_logits`` in its log-sum-exp form,
``discriminator_loss`` with one-sided label smoothing, the non-saturating
``generator_adversarial_loss``, ``gan_generator_loss``; the part names
``d_real``, ``d_fake``, ``g_adv``, ``g_l1`` as in JAX),
``losses/ssim.py``, ``losses/metrics.py`` and ``losses/sharpness.py``, with
the same formulas, clamps and masks:

- ``ssim_per_sample``: Wang et al. 2004 with an 11x11 Gaussian window
  (sigma 1.5), separable VALID blur, variance clamped at 0 and covariance at
  +-sqrt(var_p var_t); frames smaller than the window use the largest odd
  size that fits;
- ``contingency_counts`` / ``scores_from_counts``: hits, misses, false
  alarms and correct negatives at a threshold, and POD/FAR/CSI/HSS from
  them (integer counts; the host turns global sums into scores);
- ``sharpness_sums``: high-frequency spectral power fraction and mean
  gradient magnitude, as (sum, weight) pairs for exact global ratios.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


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


# SSIM's constants: an 11x11 Gaussian window of sigma 1.5, data range 1,
# K1 = 0.01 and K2 = 0.03 (the torchmetrics / skimage defaults)
SSIM_WINDOW, SSIM_SIGMA = 11, 1.5
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2


def _ssim_map(pred, target):
    """Flattened-leading-dims SSIM map [N, 1, H', W'] (VALID-cropped)."""
    h, w = pred.shape[-2], pred.shape[-1]
    p = pred.reshape(-1, 1, h, w).float()
    t = target.reshape(-1, 1, h, w).float()
    eff = min(SSIM_WINDOW, h, w)
    if eff % 2 == 0:
        eff -= 1
    win = torch.from_numpy(_gaussian_kernel(eff, SSIM_SIGMA)).to(p.device)
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
    num = (2 * mu_p * mu_t + SSIM_C1) * (2 * mu_pt + SSIM_C2)
    den = (mu_p ** 2 + mu_t ** 2 + SSIM_C1) * (mu_pp + mu_tt + SSIM_C2)
    return num / den


def ssim_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample mean SSIM [B] of batch-leading [B, ..., H, W] tensors."""
    b = pred.shape[0]
    return _ssim_map(pred, target).reshape(b, -1).mean(dim=1)


# ------------------------------------------------------ categorical scores

def contingency_counts(pred: torch.Tensor, target: torch.Tensor,
                       threshold: float, batch_mask: torch.Tensor):
    """(hits, misses, false_alarms, correct_negatives) at a threshold over
    the rows of the batch-leading tensors where ``batch_mask`` [B] is true;
    integer sums, exact at any pixel count."""
    p = pred >= threshold
    t = target >= threshold
    b = pred.shape[0]
    m = batch_mask.to(torch.int64)
    return tuple((s.reshape(b, -1).sum(dim=1) * m).sum()
                 for s in (p & t, ~p & t, p & ~t, ~p & ~t))


def _safe(num, den):
    return np.where(den > 0, num / np.maximum(den, 1), 0.0)


def scores_from_counts(a, b, c, d) -> Dict[str, float]:
    """POD/FAR/CSI/HSS from host counts (hits a, false_alarms b, misses c,
    correct_negatives d)."""
    pod = _safe(a, a + c)
    far = _safe(b, a + b)
    csi = _safe(a, a + b + c)
    expected = (a + c) * (c + d) + (a + b) * (b + d)
    hss = _safe(2 * (a * d - b * c), expected)
    return {"pod": pod, "far": far, "csi": csi, "hss": hss}


# ---------------------------------------------------------------- sharpness

def _hf_mask(h: int, w: int, cutoff: float) -> np.ndarray:
    fy = np.fft.fftfreq(h)[:, None] * 2.0
    fx = np.fft.rfftfreq(w)[None, :] * 2.0
    return np.sqrt(fy * fy + fx * fx) > cutoff


def hf_energy_fraction(x: torch.Tensor) -> torch.Tensor:
    """Spectral power fraction above half the Nyquist radius, per sample of
    [B, ..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    spec = torch.fft.rfft2(x.float()).abs() ** 2
    mask = torch.from_numpy(_hf_mask(h, w, 0.5).astype(np.float32)).to(
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
