"""TrajGRU's encoder-forecaster for precipitation nowcasting (Shi et al.,
"Deep Learning for Precipitation Nowcasting: A Benchmark and A New Model",
NeurIPS 2017, arXiv:1706.03458; the HKO-7 benchmark code,
github.com/sxjscience/HKO-7, and its PyTorch port's module layout).

A TrajGRU layer with C hidden channels and L links at step t, ``*`` a
convolution, ``s`` the sigmoid and ``f`` a leaky ReLU of slope 0.2:

    U, V  = flows_conv * f(i2f_conv1 * X_t + h2f_conv1 * H_{t-1})
            (5x5 convs: X -> 32, H -> 32, then 32 -> 2L: L flow fields)
    W_l   = warp(H_{t-1}, u_l, v_l)  bilinear sample of H at (x + u_l,
            y + v_l), zero outside the frame
    S_t   = concat_l W_l             [B, H, W, L C]
    r, z, n = split(i2h * X_t (k x k, -> 3C)) + split(ret * S_t (1x1,
            L C -> 3C))              (order r|z|n)
    R = s(r_x + r_h)   Z = s(z_x + z_h)   H' = f(n_x + R n_h)
    H_t = Z H_{t-1} + (1 - Z) H'

A layer with no input (the forecaster's top) drops the X terms.

The network, one entry a resolution from the frames up (``level_sizes``):
the encoder runs, at each level, its downsampling conv (``stems[i]``:
[out, kernel, stride, padding]) and a leaky ReLU over every input step at
once, then its TrajGRU over the ``input_frames`` steps from a zero state;
the next level reads that layer's outputs. The forecaster starts each level
from the encoder's last state of that level and runs from the top down,
``output_frames`` steps a level: the top layer has no input, each lower
layer reads the transposed conv (``deconvs[i + 1]``) and leaky ReLU of the
outputs of the layer above, and after the bottom layer come its transposed
conv and leaky ReLU, a 3x3 conv and leaky ReLU, and a 1x1 conv to the
frame's channels. The forecaster does not feed its predictions back.

Training loss (``TrajGRU.loss``): HKO-7's balanced MSE plus balanced MAE of
the predictions against the targets (``losses.balanced_mse_mae``).

How the port computes it:
- activations are NHWC; the parameters are float32 and cast to the compute
  dtype, convolution kernels in the channels-last layout, once per forward
  pass (``_cast``), not once per step;
- the convs, strided convs and transposed convs are cuDNN's on
  channels-last operands (in bf16 with float32 accumulation), but for the
  last two convs at the frames' size, which run in NCHW (``HEAD``); the
  input side of each layer (i2h and i2f_conv1) runs once over all its
  steps;
- the warp is K8 (``ops/kernels/traj_warp_kernel.py``): one launch forward
  and one backward a cell-step, all L links at once, writing S in the
  layout the 1x1 link conv (``ret``, a GEMM over the channels) reads; its
  plain version on the CPU;
- the GRU gate algebra is plain torch ops.

Module names follow the HKO-7 PyTorch port's (``encoder.stage<i>.
conv<i>_leaky_1``, ``encoder.rnn<i>.i2h|i2f_conv1|h2f_conv1|flows_conv|
ret``, ``forecaster.rnn<i>``, ``forecaster.stage<i>.deconv<n + 1 - i>_
leaky_1``, the bottom stage's ``conv<n>_leaky_2`` and ``conv<n>_3``), so
that a published state dict maps by name. Departures: the forecaster's top
layer has no ``i2h`` or ``i2f_conv1`` (that port builds them and never
reads them), and the flows are used as they come from ``flows_conv`` where
that port warps by their negative (the same family of functions: the sign
lives in ``flows_conv``'s weights and bias).

Training on the card (``loss`` with gradients on CUDA tensors) replays CUDA
graphs (``models/loss_graphs.py``, shared with the other families): from
the second call at a shape on, the forward and the backward to the
parameters' gradients are replayed.

Tracing: the encoder is the span ``plcg.trajgru.encode``, the forecaster
``plcg.trajgru.forecast`` (inside ``plcg.train.forward`` in a train step);
a replayed forward is ``plcg.loss_graphs.replay``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..losses import balanced_mse_mae
from ..ops.kernels.traj_warp_kernel import traj_warp
from ..utils.profiling import span
from .loss_graphs import loss_graphs

SLOPE = 0.2            # every leaky ReLU's
FLOW_KERNEL = 5        # the flow generator's convs
FLOW_CHANNELS = 32     # and their width
# the bottom stage's convs after its transposed conv (``conv<n>_leaky_2``,
# ``conv<n>_3``): frame-sized, a few channels; cuDNN's NCHW kernels run
# them faster than its channels-last ones (on the H100 at B 4 x 20 frames
# of 480^2, 8 -> 8 and 8 -> 1 channels: 10.8 against 14.2 ms and 1.2
# against 10.2 ms, forward and backward)
HEAD = ("_leaky_2", "_3")


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _deconv_out(n: int, k: int, s: int, p: int) -> int:
    return (n - 1) * s - 2 * p + k


def level_sizes(height: int, width: int, stems: Sequence[Sequence[int]],
                deconvs: Sequence[Sequence[int]]) -> List[Tuple[int, int]]:
    """Each level's (H, W) for frames of ``height`` x ``width``: the stems'
    strided convs applied in turn. Raises ValueError unless each level's
    transposed conv brings the level above (or the frames) back to the size
    the stem took it from."""
    sizes, hw = [], (height, width)
    for i, (_, k, s, p) in enumerate(stems):
        nxt = tuple(_conv_out(n, k, s, p) for n in hw)
        _, dk, ds, dp = deconvs[i]
        back = tuple(_deconv_out(n, dk, ds, dp) for n in nxt)
        if min(nxt) < 1 or back != hw:
            raise ValueError(f"trajgru level {i}: the stem {list(stems[i])} "
                             f"takes {hw} to {nxt}, and the transposed conv "
                             f"{list(deconvs[i])} gives {back} back")
        sizes.append(nxt)
        hw = nxt
    return sizes


class TrajGRUCell(nn.Module):
    """One TrajGRU layer's parameters (the HKO-7 PyTorch port's names and
    shapes, every conv with a bias); ``input_channel`` 0: no input (no
    ``i2h``, no ``i2f_conv1``)."""

    def __init__(self, input_channel: int, num_filter: int, links: int,
                 kernel_size: int = 3):
        super().__init__()
        self.num_filter, self.links = num_filter, links
        if input_channel:
            self.i2h = nn.Conv2d(input_channel, 3 * num_filter, kernel_size,
                                 padding=kernel_size // 2)
            self.i2f_conv1 = nn.Conv2d(input_channel, FLOW_CHANNELS,
                                       FLOW_KERNEL, padding=FLOW_KERNEL // 2)
        self.h2f_conv1 = nn.Conv2d(num_filter, FLOW_CHANNELS, FLOW_KERNEL,
                                   padding=FLOW_KERNEL // 2)
        self.flows_conv = nn.Conv2d(FLOW_CHANNELS, 2 * links, FLOW_KERNEL,
                                    padding=FLOW_KERNEL // 2)
        self.ret = nn.Conv2d(num_filter * links, 3 * num_filter, 1)


def _stage(layers: Sequence[Tuple[str, nn.Module]]) -> nn.Module:
    stage = nn.Module()
    for name, layer in layers:
        setattr(stage, name, layer)
    return stage


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Conv of NHWC ``x`` with an OIHW kernel in x's dtype; channels-last
    operands give an NHWC-contiguous result on the card."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding)
    return out.permute(0, 2, 3, 1)


def deconv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int, padding: int) -> torch.Tensor:
    """Transposed conv of NHWC ``x`` with an [in, out, k, k] kernel."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride, padding)
    return out.permute(0, 2, 3, 1)


def traj_step(w: Dict[str, torch.Tensor], x_r: Optional[torch.Tensor],
              x_f: Optional[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """One TrajGRU cell-step on NHWC tensors: H_t from H_{t-1} ``h``, the
    step's input terms ``x_r`` (i2h's, [B, H, W, 3C]) and ``x_f``
    (i2f_conv1's) or None (no input), and the layer's cast weights ``w``
    (``ret.weight`` as a [3C, L C] matrix)."""
    f = conv_nhwc(h, w["h2f_conv1.weight"], w["h2f_conv1.bias"],
                  padding=FLOW_KERNEL // 2)
    if x_f is not None:
        f = f + x_f
    flows = conv_nhwc(F.leaky_relu(f, SLOPE), w["flows_conv.weight"],
                      w["flows_conv.bias"], padding=FLOW_KERNEL // 2)
    stack = traj_warp(h, flows)
    h_r, h_z, h_n = F.linear(stack, w["ret.weight"], w["ret.bias"]).split(
        h.shape[-1], dim=-1)
    if x_r is None:
        reset, update = torch.sigmoid(h_r), torch.sigmoid(h_z)
        new = reset * h_n
    else:
        x_rr, x_z, x_n = x_r.split(h.shape[-1], dim=-1)
        reset, update = torch.sigmoid(x_rr + h_r), torch.sigmoid(x_z + h_z)
        new = x_n + reset * h_n
    new = F.leaky_relu(new, SLOPE)
    return update * h + (1.0 - update) * new


class TrajGRU(nn.Module):
    """frames [B, T_in, C, H, W] -> predictions [B, T_out, C, H, W] float32
    (``forward``); ``loss`` trains on (inputs, targets)."""

    loss_name = "Balanced MSE+MAE"

    def __init__(self, hidden_dims: Sequence[int] = (64, 192, 192),
                 links: Sequence[int] = (13, 13, 9),
                 forecast_links: Sequence[int] = (9, 13, 13),
                 stems: Sequence[Sequence[int]] = ((8, 7, 5, 1),
                                                   (192, 5, 3, 1),
                                                   (192, 3, 2, 1)),
                 deconvs: Sequence[Sequence[int]] = ((8, 7, 5, 1),
                                                     (64, 5, 3, 1),
                                                     (192, 4, 2, 1)),
                 input_frames: int = 5, output_frames: int = 20,
                 in_channels: int = 1, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = len(hidden_dims)
        if not n or {len(links), len(forecast_links), len(stems),
                     len(deconvs)} != {n}:
            raise ValueError(f"TrajGRU needs one link count, stem and "
                             f"transposed conv a level, got {n} widths, "
                             f"{len(links)} / {len(forecast_links)} link "
                             f"counts, {len(stems)} stems and "
                             f"{len(deconvs)} transposed convs")
        self.hidden_dims = tuple(hidden_dims)
        self.stems = [tuple(s) for s in stems]
        self.deconvs = [tuple(d) for d in deconvs]
        self.input_frames = input_frames
        self.output_frames = output_frames
        self.in_channels = in_channels
        self.dtype = dtype
        self.encoder = nn.Module()
        for i in range(n):
            out, k, s, p = self.stems[i]
            cin = in_channels if i == 0 else hidden_dims[i - 1]
            setattr(self.encoder, f"stage{i + 1}", _stage([
                (f"conv{i + 1}_leaky_1", nn.Conv2d(cin, out, k, s, p))]))
            setattr(self.encoder, f"rnn{i + 1}", TrajGRUCell(
                out, hidden_dims[i], links[i], kernel_size))
        self.forecaster = nn.Module()
        for i in reversed(range(n)):
            cin = 0 if i == n - 1 else self.deconvs[i + 1][0]
            setattr(self.forecaster, f"rnn{i + 1}", TrajGRUCell(
                cin, hidden_dims[i], forecast_links[i], kernel_size))
            out, k, s, p = self.deconvs[i]
            layers = [(f"deconv{n - i}_leaky_1", nn.ConvTranspose2d(
                hidden_dims[i], out, k, s, p))]
            if i == 0:
                layers += [(f"conv{n}_leaky_2", nn.Conv2d(out, out, 3, 1, 1)),
                           (f"conv{n}_3", nn.Conv2d(out, in_channels, 1))]
            setattr(self.forecaster, f"stage{i + 1}", _stage(layers))

    @property
    def levels(self) -> int:
        return len(self.hidden_dims)

    def teacher_probs(self, p: float) -> torch.Tensor:
        """No scheduled sampling (the forecaster does not feed its
        predictions back): no draws."""
        return torch.zeros(0)

    def _weights(self) -> List[torch.Tensor]:
        """Every parameter, in the module's order."""
        return list(self.parameters())

    def _cast(self, dtype, weights=None) -> Dict[str, torch.Tensor]:
        """``weights`` (None: the parameters, in ``_weights()``'s order) by
        name in ``dtype``, once per forward pass: conv kernels in the
        channels-last layout but those of the bottom stage's two last convs
        (``HEAD``, run in NCHW), each ``ret`` kernel as a [3C, L C]
        matrix."""
        names = [name for name, _ in self.named_parameters()]
        head = tuple(f"forecaster.stage1.conv{self.levels}{k}.weight"
                     for k in HEAD)
        out = {}
        for name, w in zip(names, self._weights() if weights is None
                           else weights):
            if name.endswith("ret.weight"):
                out[name] = w.to(dtype).reshape(w.shape[0], -1)
            elif name in head:
                out[name] = w.to(dtype).contiguous()
            elif w.dim() == 4:
                out[name] = w.to(dtype=dtype,
                                 memory_format=torch.channels_last)
            else:
                out[name] = w.to(dtype)
        return out

    @staticmethod
    def _cell(w: Dict[str, torch.Tensor], prefix: str):
        return {k[len(prefix):]: v for k, v in w.items()
                if k.startswith(prefix)}

    def _layer(self, w: Dict[str, torch.Tensor], x: Optional[torch.Tensor],
               h: torch.Tensor, steps: int) -> torch.Tensor:
        """One TrajGRU layer over ``steps`` steps from ``h`` [B, H, W, C]:
        its input terms over all steps at once from ``x`` [steps B, H, W,
        Cin] (or none), then the recurrence; the outputs [steps, B, H, W,
        C]."""
        b = h.shape[0]
        x_r = x_f = None
        if x is not None:
            k = w["i2h.weight"].shape[-1]
            x_r = conv_nhwc(x, w["i2h.weight"], w["i2h.bias"], padding=k // 2)
            x_f = conv_nhwc(x, w["i2f_conv1.weight"], w["i2f_conv1.bias"],
                            padding=FLOW_KERNEL // 2)
        outs = []
        for t in range(steps):
            rows = slice(t * b, (t + 1) * b)
            h = traj_step(w, None if x_r is None else x_r[rows],
                          None if x_f is None else x_f[rows], h)
            outs.append(h)
        return torch.stack(outs)

    def rollout(self, frames: torch.Tensor, weights=None) -> torch.Tensor:
        """The encoder over ``frames`` [B, T_in, C, H, W], then the
        forecaster's ``output_frames`` steps: the predictions [T_out, B, H,
        W, C] in the compute dtype. ``weights``: ``_weights()``'s in its
        order, or None."""
        b, t_in, c, hgt, wid = frames.shape
        if c != self.in_channels:
            raise ValueError(f"frames [B, T, {self.in_channels}, H, W], got "
                             f"{tuple(frames.shape)}")
        sizes = level_sizes(hgt, wid, self.stems, self.deconvs)
        cdtype = self.dtype or frames.dtype
        w = self._cast(cdtype, weights)
        x = frames.to(cdtype).transpose(0, 1).reshape(t_in * b, c, hgt, wid)
        x = x.permute(0, 2, 3, 1).contiguous()          # [T B, H, W, C]
        n, t_out = self.levels, self.output_frames
        states = []
        with span("trajgru.encode"):
            for i in range(n):
                _, _, s, p = self.stems[i]
                name = f"encoder.stage{i + 1}.conv{i + 1}_leaky_1"
                x = F.leaky_relu(conv_nhwc(x, w[name + ".weight"],
                                           w[name + ".bias"], s, p), SLOPE)
                h0 = x.new_zeros((b, *sizes[i], self.hidden_dims[i]))
                outs = self._layer(self._cell(w, f"encoder.rnn{i + 1}."), x,
                                   h0, t_in)
                states.append(outs[-1])
                x = outs.reshape(t_in * b, *outs.shape[2:])
        with span("trajgru.forecast"):
            x = None
            for i in reversed(range(n)):
                outs = self._layer(self._cell(w, f"forecaster.rnn{i + 1}."),
                                   x, states[i], t_out)
                x = outs.reshape(t_out * b, *outs.shape[2:])
                _, _, s, p = self.deconvs[i]
                pre = f"forecaster.stage{i + 1}."
                name = pre + f"deconv{n - i}_leaky_1"
                x = F.leaky_relu(deconv_nhwc(x, w[name + ".weight"],
                                             w[name + ".bias"], s, p), SLOPE)
            # the frame-sized convs of a few channels run in NCHW
            x = x.permute(0, 3, 1, 2).contiguous()
            name = pre + f"conv{n}_leaky_2"
            x = F.leaky_relu(F.conv2d(x, w[name + ".weight"],
                                      w[name + ".bias"], 1, 1), SLOPE)
            name = pre + f"conv{n}_3"
            x = F.conv2d(x, w[name + ".weight"], w[name + ".bias"])
        return x.permute(0, 2, 3, 1).reshape(t_out, b, hgt, wid, c)

    @staticmethod
    def _outputs(preds: torch.Tensor) -> torch.Tensor:
        """[T_out, B, H, W, C] -> [B, T_out, C, H, W] float32."""
        return preds.permute(1, 0, 4, 2, 3).float()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """The ``output_frames`` predictions after ``frames`` [B, T_in, C, H,
        W]."""
        if frames.shape[1] != self.input_frames:
            raise ValueError(f"expected a {self.input_frames}-frame input "
                             f"window (input_frames), got {frames.shape[1]}")
        return self._outputs(self.rollout(frames))

    def loss(self, inputs: torch.Tensor, targets: torch.Tensor,
             teacher_draws: Optional[torch.Tensor] = None):
        """(balanced MSE + MAE of the predictions against ``targets`` [B,
        T_out, C, H, W], the predictions [B, T_out, C, H, W] float32).

        With gradients on CUDA tensors, from the second call at a shape on,
        replayed from CUDA graphs (``models/loss_graphs.py``)."""
        if teacher_draws is not None:
            raise ValueError("TrajGRU's forecaster does not feed its "
                             "predictions back: no scheduled-sampling draws")
        return loss_graphs(self, self._weights(), self._loss, inputs,
                           targets)

    def _loss(self, inputs, targets, extra=None, weights=None):
        """``loss``, eagerly (on ``weights`` in ``_weights()``'s order, or
        the parameters)."""
        pred = self._outputs(self.rollout(inputs, weights))
        return balanced_mse_mae(pred, targets.float()), pred
