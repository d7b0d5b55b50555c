"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 and the
operations and bytes of the work each cell runs, computed from shapes.

The counts are of the work, whatever implements it: a convolution's
operations are 2 * pixels * K^2 * Cin * Cout, however the program computes
it, so a later change of kernel leaves the roofline and MFU readings
comparable. ``rollout_bound_ms`` is a frozen copy of ``chip_smoke.py``'s
arithmetic of the same name (a rollout as one function: every conv's
operations at the dtype's peak against its inputs, weights and outputs
moved once at the memory rate).
"""
from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 989 TFLOP/s, TF32 495 TFLOP/s,
# float32 outside the tensor cores 67 TFLOP/s; HBM3 3.35 TB/s.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def conv_flops(pixels: int, k: int, cin: int, cout: int) -> int:
    """Operations of one convolution over ``pixels`` output pixels."""
    return 2 * pixels * k * k * cin * cout


def bound_ms(flops: float, nbytes: float, dtype_name: str
             ) -> Tuple[float, str]:
    """(least time in ms, "operations" or "bytes"): the larger of the
    operations at the dtype's peak and the bytes at the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cell_step_flops(pixels: int, cin: int, hidden: Sequence[int],
                    k: int = 3) -> int:
    """One step of stacked ConvLSTM cells: each cell's conv over
    concat(x, h) to 4 * hidden channels."""
    flops, cx = 0, cin
    for ch in hidden:
        flops += conv_flops(pixels, k, cx + ch, 4 * ch)
        cx = ch
    return flops


def rollout_flops(b: int, hgt: int, wid: int, cin: int,
                  hidden: Sequence[int], steps: int, heads: int,
                  k: int = 3) -> int:
    """``steps`` cell steps and ``heads`` 3x3 head convs (top h -> cin)."""
    px = b * hgt * wid
    return (steps * cell_step_flops(px, cin, hidden, k)
            + heads * conv_flops(px, 3, hidden[-1], cin))


def rollout_bound_ms(b, hgt, wid, cin, hidden, steps, heads, frames_in,
                     k=3, dtype_name="bfloat16") -> Tuple[float, str]:
    """A rollout's bound as one function: operations (every cell phase's
    conv and every head phase's) at the dtype's peak against bytes (the
    frames in, the seeds, every weight, the outputs and the final state,
    each once) at the memory rate; ``steps`` cell steps, ``heads`` head
    steps, ``frames_in`` frames read."""
    px = b * hgt * wid
    flops, wbytes, cx = 0, 0, cin
    for ch in hidden:
        flops += 2 * px * k * k * (cx + ch) * 4 * ch
        wbytes += k * k * (cx + ch) * 4 * ch + 4 * ch
        cx = ch
    flops = steps * flops + heads * 2 * px * 9 * cx * cin
    state = 2 * px * sum(hidden)                  # (h, c) of every cell
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * (frames_in * px * cin + state + wbytes + 9 * cx * cin
                     + cin + heads * px * cin + state)
    return bound_ms(flops, nbytes, dtype_name)


def stream_request(model: dict, horizon: int) -> Tuple[int, float]:
    """(operations, bound ms) of one streaming request at B 1: ``observe``
    of one frame (one step and the head), then ``forecast(horizon)`` (one
    step and the head a frame), each bounded as one function."""
    hw, cin, hid = model["image_size"], model["in_channels"], \
        model["hidden_dims"]
    obs = rollout_bound_ms(1, hw, hw, cin, hid, 1, 1, 1)[0]
    fc = rollout_bound_ms(1, hw, hw, cin, hid, horizon, horizon, 0)[0]
    flops = (rollout_flops(1, hw, hw, cin, hid, 1, 1)
             + rollout_flops(1, hw, hw, cin, hid, horizon, horizon))
    return flops, obs + fc


def forecaster_forward_flops(model: dict, batch: int) -> int:
    """The training forward's convolutions: T_in + T_out - 1 cell steps and
    T_out head convs (``ConvLSTMForecaster.forward``)."""
    hw = model["image_size"]
    t_in, t_out = model["input_frames"], model["output_frames"]
    return rollout_flops(batch, hw, hw, model["in_channels"],
                         model["hidden_dims"], t_in + t_out - 1, t_out,
                         model.get("kernel_size", 3))


def num_upsample_blocks(scale: int) -> int:
    s, n = int(scale), 0
    while s >= 2:
        n += 1
        s //= 2
    return n


def generator_forward_flops(model: dict, batch: int) -> int:
    """The downscaling Generator's convolutions on [B, T, 1, H, W]: the
    CoordConv stem and the decode over T * B, the cells T steps over B,
    the DEM and LUCC gates once over B (broadcast over T)."""
    t, hw, cin = model["T"], model["image_size"], model["in_channels"]
    hd, scale = model["hidden_dims"], int(model["scale_factor"])
    n = t * batch
    lo = hw * hw
    flops = conv_flops(n * lo, 3, cin + 2, hd[0])
    flops += t * cell_step_flops(batch * lo, hd[0], hd, 3)
    side = hw
    for _ in range(num_upsample_blocks(scale)):
        flops += conv_flops(n * side * side, 3, hd[-1], 4 * hd[-1])
        side *= 2
    hi = (hw * scale) ** 2
    for cov in (model["dem_channels"], model["lu_channels"]):
        flops += conv_flops(batch * hi, 3, cov, hd[-1] // 2)
        flops += conv_flops(batch * hi, 1, hd[-1] // 2, hd[-1])
    flops += conv_flops(n * hi, 3, hd[-1], 32) + conv_flops(n * hi, 3, 32, 1)
    return flops


def train_step_flops(family: str, model: dict, batch: int) -> int:
    """A train step's model operations: the forward's convolutions times 3
    (the forward, the input gradient, the weight gradient)."""
    fwd = (forecaster_forward_flops if family == "forecaster"
           else generator_forward_flops)
    return 3 * fwd(model, batch)
