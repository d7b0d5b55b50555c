"""The operations and bytes of PredRNN-V2's work, computed from shapes (the
yardstick of ``step_mfu.train_rss`` and ``st_gates_roofline.train_rss``).

Operations count the work, whatever implements it: each cell-step's five
convolutions (conv_x, conv_h, conv_m, conv_o 2 * px * K^2 * Cin * Cout;
conv_last 1 x 1), the head's 1 x 1 conv each step, and the decoupling
adapter's 1 x 1 conv of every delta_c and delta_m; a train step is three
times the forward (the forward, the input gradient, the weight gradient).

Bytes are what K7's passes (``csrc/st_lstm_gates.cu``) need: each operand
a launch reads and each result it writes counted once, at its dtype (the
compute dtype; ``oxh`` and its gradient in float32). Pass A writes c' and m'
twice, as ``mem``'s halves and again apart (so that autograd adds no
gradient sums); the bound counts them once. A train step launches each of the
four passes once a cell-step; its backward reads no gradient of c' at the
last step (nothing reads that c'), nor of the top layer's m' there, and
writes no dc_prev at step 0 (c starts at zero) nor layer 0's dm_prev there
(m starts at zero).
"""
from __future__ import annotations

from .flops import conv_flops

ELEM = {"bfloat16": 2, "float32": 4}


def _dims(model: dict, batch: int):
    p = model["patch_size"]
    px = batch * (model["image_size"] // p) ** 2
    steps = model["input_frames"] + model["output_frames"] - 1
    return px, model["hidden_dims"][0], len(model["hidden_dims"]), steps, \
        p * p * model["in_channels"]


def cell_step_flops(px: int, cin: int, fw: int, k: int) -> int:
    """One ST-LSTM cell-step's convolutions."""
    return (conv_flops(px, k, cin, 7 * fw) + conv_flops(px, k, fw, 4 * fw)
            + conv_flops(px, k, fw, 3 * fw) + conv_flops(px, k, 2 * fw, fw)
            + conv_flops(px, 1, 2 * fw, fw))


def forward_flops(model: dict, batch: int) -> int:
    """The training forward: every cell-step, the head every step, the
    adapter on both deltas of every cell-step."""
    px, fw, layers, steps, frame_channel = _dims(model, batch)
    k = model["kernel_size"]
    cells = sum(cell_step_flops(px, frame_channel if i == 0 else fw, fw, k)
                for i in range(layers))
    head = conv_flops(px, 1, fw, frame_channel)
    adapter = 2 * layers * conv_flops(px, 1, fw, fw)
    return steps * (cells + head + adapter)


def train_step_flops(model: dict, batch: int) -> int:
    return 3 * forward_flops(model, batch)


def k7_launch_bytes(kind: str, px: int, fw: int, dtype: str) -> int:
    """Bytes one K7 launch of ``kind`` moves with every operand present:
    "a_fwd" reads x_cat, h_cat, m_cat, c, m (16F) and writes mem = c' | m',
    dc, dm (4F; c' and m' written again apart are not counted) and oxh
    (float32); "b_fwd" reads oxh, om, last and writes
    h'; "a_bwd" reads x_cat's, h_cat's and m_cat's gates without o (12F),
    c, m, the gradients of mem, c', m', dc, dm (6F) and of oxh (float32),
    and writes dx_cat, dh_cat, dm_cat, dc_prev, dm_prev (16F); "b_bwd"
    reads gh, oxh, om, last and writes d_oxh (float32), d_om, d_last."""
    e = ELEM[dtype]
    per = {"a_fwd": 20 * e + 4, "b_fwd": 3 * e + 4,
           "a_bwd": 36 * e + 4, "b_bwd": 5 * e + 8}[kind]
    return px * fw * per


def k7_step_bytes(model: dict, batch: int, dtype: str) -> int:
    """K7's bytes over a train step (module docstring)."""
    px, fw, layers, steps, _ = _dims(model, batch)
    n = layers * steps
    full = n * sum(k7_launch_bytes(kind, px, fw, dtype)
                   for kind in ("a_fwd", "b_fwd", "a_bwd", "b_bwd"))
    absent = 2 * (layers + 1)          # (c', top m') at the last step;
    return full - absent * px * fw * ELEM[dtype]   # (dc, layer 0 dm) at 0
