"""The operations and bytes of TrajGRU's work, computed from shapes (the
yardstick of ``step_mfu.train`` and ``traj_warp_roofline.train_hko`` on
``trajgru_hko7_bf16.train_hko``).

Operations count the work, whatever implements it: every convolution
(2 * output pixels * K^2 * Cin * Cout: the encoder's strided convs over
every input frame, each layer's i2h and i2f_conv1 over every step it reads,
h2f_conv1 and flows_conv every step, the bottom stage's 3x3 and 1x1 convs
over every output frame), every transposed convolution (2 * input pixels *
K^2 * Cin * Cout) and every link GEMM (``ret``: 2 * pixels * L C * 3C); a
train step is three times the forward (the forward, the input gradient,
the weight gradient). The warp, the gates and the loss are not counted.

Bytes are what K8 (``csrc/traj_warp.cu``) needs, each operand a launch
reads and each result it writes counted once, at the compute dtype: the
forward reads h (C a pixel) and the flows (2L) and writes the stack S
(L C); the backward reads the stack's gradient (L C), h and the flows,
adds into dh in float32 (C, counted once: the atomics' repeated updates of
one value stay in L2) and writes the flows' gradient (2L). A tap of h read
again by a neighbouring pixel or link is not counted again. A train step
launches each once a cell-step: the encoder's ``input_frames`` and the
forecaster's ``output_frames`` steps at every level.
"""
from __future__ import annotations

from typing import List, Tuple

from .flops import conv_flops

ELEM = {"bfloat16": 2, "float32": 4}
FLOW_CHANNELS = 32          # the flow generator's width


def level_pixels(model: dict, batch: int) -> List[int]:
    """Each level's pixels (rows x H x W), the stems' strided convs applied
    to ``image_size`` in turn."""
    out, size = [], model["image_size"]
    for _, k, s, p in model["traj_stems"]:
        size = (size + 2 * p - k) // s + 1
        out.append(batch * size * size)
    return out


def cell_step_flops(px: int, cin: int, c: int, links: int, k: int,
                    fc: int) -> int:
    """One TrajGRU cell-step: i2h and i2f_conv1 (where ``cin``), h2f_conv1,
    flows_conv and the link GEMM."""
    x_side = conv_flops(px, k, cin, 3 * c) + conv_flops(px, 5, cin, fc) \
        if cin else 0
    return (x_side + conv_flops(px, 5, c, fc) + conv_flops(px, 5, fc,
                                                           2 * links)
            + 2 * px * links * c * 3 * c)


def forward_flops(model: dict, batch: int) -> int:
    """The training forward (module docstring)."""
    hidden, stems = model["hidden_dims"], model["traj_stems"]
    deconvs, n = model["traj_deconvs"], len(model["hidden_dims"])
    k, fc = model["kernel_size"], FLOW_CHANNELS
    t_in, t_out = model["input_frames"], model["output_frames"]
    pxs = level_pixels(model, batch)
    total = 0
    for i in range(n):
        out, sk = stems[i][0], stems[i][1]
        cin = model["in_channels"] if i == 0 else hidden[i - 1]
        total += t_in * (conv_flops(pxs[i], sk, cin, out) + cell_step_flops(
            pxs[i], out, hidden[i], model["traj_links"][i], k, fc))
        f_in = 0 if i == n - 1 else deconvs[i + 1][0]
        d_out, dk = deconvs[i][0], deconvs[i][1]
        total += t_out * (cell_step_flops(
            pxs[i], f_in, hidden[i], model["traj_forecast_links"][i], k, fc)
            + conv_flops(pxs[i], dk, hidden[i], d_out))
    frames = batch * model["image_size"] ** 2
    d_out = deconvs[0][0]
    total += t_out * (conv_flops(frames, 3, d_out, d_out)
                      + conv_flops(frames, 1, d_out, model["in_channels"]))
    return total


def train_step_flops(model: dict, batch: int) -> int:
    return 3 * forward_flops(model, batch)


def k8_launch_bytes(kind: str, px: int, c: int, links: int,
                    dtype: str) -> int:
    """Bytes one K8 launch of ``kind`` moves: "fwd" reads h and the flows
    and writes S; "bwd" reads gS, h and the flows, adds into the float32 dh
    and writes dflows."""
    e = ELEM[dtype]
    if kind == "fwd":
        return px * e * (c + 2 * links + links * c)
    return px * (e * (links * c + c + 4 * links) + 4 * c)


def cell_steps(model: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(pixels, C, L, steps) of each TrajGRU layer, encoder then
    forecaster."""
    pxs = level_pixels(model, batch)
    hidden = model["hidden_dims"]
    return ([(pxs[i], hidden[i], model["traj_links"][i],
              model["input_frames"]) for i in range(len(hidden))]
            + [(pxs[i], hidden[i], model["traj_forecast_links"][i],
                model["output_frames"]) for i in range(len(hidden))])


def k8_step_bytes(model: dict, batch: int, dtype: str) -> int:
    """K8's bytes over a train step (module docstring)."""
    return sum(steps * (k8_launch_bytes("fwd", px, c, links, dtype)
                        + k8_launch_bytes("bwd", px, c, links, dtype))
               for px, c, links, steps in cell_steps(model, batch))
