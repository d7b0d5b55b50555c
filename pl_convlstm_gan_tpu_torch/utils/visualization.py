"""Training-curve, sequence and station-comparison plots: a copy of the JAX
package's ``utils/visualization.py`` (the same figures, sizes and dpi, so the
same pixels).

matplotlib is optional: each function imports it when called, with the Agg
backend, so that importing this module (and the trainers) loads none of it.
Where matplotlib is not installed (``have_matplotlib``), the trainers print
one line and draw nothing: plots are a by-product of a run, not a path of
the device or of a kernel."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def have_matplotlib() -> bool:
    """True where matplotlib is installed (without importing it)."""
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def plot_stations_vs_pred(s_coords, true_vals, pred_vals,
                          save_path: str = "station_comparison.png",
                          dpi: int = 300) -> None:
    """Scatter of per-station observed vs predicted precipitation, with the
    y = x ideal-prediction diagonal."""
    plt = _pyplot()
    true_vals = np.asarray(true_vals)
    pred_vals = np.asarray(pred_vals)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.scatter(true_vals, pred_vals, alpha=0.7)
    lo = min(true_vals.min(), pred_vals.min())
    hi = max(true_vals.max(), pred_vals.max())
    ax.plot([lo, hi], [lo, hi], "r--", label="Ideal Prediction")
    ax.set(xlabel="True Values", ylabel="Predicted Values",
           title="Station Observed vs Predicted Precipitation")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=dpi)
    plt.close(fig)


def plot_sequence_comparison(inputs, targets, preds,
                             save_path: str = "sequence_comparison.png",
                             dpi: int = 150, max_frames: int = 10) -> None:
    """Frame-grid comparison for sequence prediction: rows = (context, target,
    prediction), columns = timesteps. inputs [T_in,H,W], targets/preds [T_out,H,W]
    (leading channel dims of size 1 are squeezed). No reference equivalent — the
    forecaster/GAN families' visual sanity check."""
    def prep(x):
        """Normalize to [T, H, W]. Accepted layouts: [T,H,W], [T,C,H,W], and
        batch-leading [B,T,C,H,W] (first item). Multi-channel frames plot
        channel 0; the TIME axis is never squeezed (a [1,H,W] single-frame
        sequence must stay 3-D — squeezing it would plot H rows as frames)."""
        x = np.asarray(x)
        if x.ndim == 5:          # [B, T, C, H, W] -> first batch item
            x = x[0]
        if x.ndim == 4:          # [T, C, H, W] -> channel 0
            x = x[:, 0]
        return x

    plt = _pyplot()
    inputs, targets, preds = prep(inputs), prep(targets), prep(preds)
    t_in = min(len(inputs), max_frames)
    t_out = min(len(targets), max_frames)
    cols = max(t_in, t_out)
    vmax = max(targets.max(), preds.max(), 1e-6)

    fig, axes = plt.subplots(3, cols, figsize=(1.6 * cols, 5.2))
    if cols == 1:
        axes = axes[:, None]
    for r, (row, title) in enumerate([(inputs[:t_in], "context"),
                                      (targets[:t_out], "target"),
                                      (preds[:t_out], "prediction")]):
        for ci in range(cols):
            ax = axes[r, ci]
            ax.set_axis_off()
            if ci < len(row):
                ax.imshow(row[ci], cmap="viridis", vmin=0.0, vmax=float(vmax))
                if ci == 0:
                    ax.set_title(title, loc="left", fontsize=9)
    fig.tight_layout()
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


# (history keys, label) series drawn in the components panel
_COMPONENT_SERIES = [("point_loss", "Point Loss"), ("conserve_loss", "Conserve Loss"),
                     ("smooth_loss", "Smooth Loss"), ("temporal_loss", "Temporal Loss"),
                     ("g_loss", "Generator Loss"), ("d_loss", "Discriminator Loss")]


def plot_training_curves(history: Dict[str, Sequence], save_path: str =
                         "training_curves.png", dpi: int = 300) -> None:
    """2x2 convergence panel from a history dict (reference keys: epoch,
    total_loss, rmse, *_loss components, learning_rate)."""
    plt = _pyplot()
    epochs = history["epoch"]

    def series(key):
        vals = history.get(key, [])
        return vals if len(vals) == len(epochs) else None

    fig, axes = plt.subplots(2, 2, figsize=(15, 10))
    panels = [
        (axes[0, 0], "Training Loss Convergence", "Total Loss",
         [("total_loss", None, "b-")], None),
        (axes[0, 1], "RMSE Convergence", "RMSE",
         [("rmse", None, "r-")], None),
        (axes[1, 0], "Loss Components", "Loss",
         [(k, lbl, None) for k, lbl in _COMPONENT_SERIES], None),
        (axes[1, 1], "Learning Rate Schedule", "Learning Rate",
         [("learning_rate", None, "g-")], "log"),
    ]
    for ax, title, ylabel, lines, yscale in panels:
        drew_any = False
        for key, label, style in lines:
            vals = series(key)
            if vals is None:
                continue
            if style:
                ax.plot(epochs, vals, style, linewidth=2)
            else:
                ax.plot(epochs, vals, label=label, linewidth=1.5)
            drew_any = True
        ax.set(xlabel="Epoch", ylabel=ylabel, title=title)
        if yscale and drew_any:
            ax.set_yscale(yscale)
        if any(label for _, label, _ in lines):
            handles, _ = ax.get_legend_handles_labels()
            if handles:
                ax.legend()
        ax.grid(True, alpha=0.3)

    fig.tight_layout()
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    print(f"Training curves saved to {save_path}")
