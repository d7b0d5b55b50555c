"""PredRNN-V2: stacked spatiotemporal LSTM (ST-LSTM) cells with a zigzag
memory and the decoupling loss (Wang et al., NeurIPS 2017 and TPAMI 2022,
arXiv:2103.09504; the public code github.com/thuml/predrnn-pytorch,
``core/models/predrnn_v2.py``, ``core/layers/SpatioTemporalLSTMCell_v2.py``).

A cell with F hidden channels, ``*`` a conv without bias, ``s`` the sigmoid:

    x_cat = W_x * x  (7F: i f g i' f' g' o)   h_cat = W_h * h  (4F: i f g o)
    m_cat = W_m * m  (3F: i f g)
    i  = s(i_x + i_h)   f  = s(f_x + f_h + 1)   g  = tanh(g_x + g_h)
    i' = s(i'_x + i_m)  f' = s(f'_x + f_m + 1)  g' = tanh(g'_x + g_m)
    dc = i g   c' = f c + dc   dm = i' g'   m' = f' m + dm
    mem = concat(c', m')   o = s(o_x + o_h + W_o * mem)
    h' = o tanh(W_1x1 * mem)

The stack: layer l at step t reads the memory m that layer l - 1 wrote at
step t, layer 0 the one the top layer wrote at step t - 1 (the zigzag).
Frames are folded p x p into channels (``reshape_patch``, thuml's channel
order (py p + px) C + c); the head is a 1 x 1 conv without bias, F -> p^2 C.
Step 0 reads frame 0; step t >= 1 reads ``mask[t - 1] ? frame t : x_gen``,
the previous step's prediction (reverse scheduled sampling over all
``T_in + T_out - 2`` choices). Without a mask the input frames are read
while there are any, then the model's own predictions (thuml's test mask).

Training loss (``PredRNN.loss``): the MSE of the ``T_in + T_out - 1``
predictions against frames 1.. plus ``decouple_beta`` times the decoupling
loss, the mean over steps, layers, rows and channels of |cos| between
``adapter(dc)`` and ``adapter(dm)`` over the pixels (one shared 1 x 1 conv
F -> F without bias).

How the port computes it:
- activations are NHWC; the parameters are float32 and cast to the compute
  dtype, in the channels-last layout, once per forward pass
  (``_cast_weights``), not once per step;
- the convs are cuDNN's (``F.conv2d`` on channels-last operands: in bf16
  with float32 accumulation);
- the gate algebra is K7 (``ops/kernels/st_gates_kernel.py``): pass A
  (``st_gates``) and pass B (``st_hidden``), each a launch forward and
  backward on the card, their plain versions on the CPU;
- the decoupling loss reads dc and dm but feeds nothing back into the
  recurrence, so it is computed once after the loop (``decoupling_loss``):
  the 2 x steps x layers deltas stacked, one adapter GEMM, one reduction.
  That is exact: the same cosines as the per-step form, the same mean, only
  computed in another order (``tests/test_torch_predrnn.py`` holds the two
  together).

Module names follow thuml's (``cell_list.<i>.conv_x|conv_h|conv_m|conv_o|
conv_last``, ``conv_last``, ``adapter``; thuml's ``conv_x.0`` is this
``conv_x``), so a published state dict maps by dropping the
``nn.Sequential``'s ``.0``.

Training on the card (``loss`` with gradients on CUDA tensors) replays CUDA
graphs (``models/loss_graphs.py``, shared with the ConvLSTM forecaster):
from the second call at a shape on, the forward (rollout, decoupling term
and MSE) and the backward to the parameters' gradients are replayed. A step
at thuml's widths is ~2,700 launches: issued one by one they take the host
longer than the device takes to run them, and the step would time the host.

Tracing: the recurrence is the span ``plcg.predrnn.rollout``, the batched
decoupling term ``plcg.predrnn.decouple`` (inside ``plcg.train.forward`` in
a train step); a replayed forward is ``plcg.loss_graphs.replay``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.st_gates_kernel import st_gates, st_hidden
from ..utils.profiling import span
from .loss_graphs import loss_graphs


def reshape_patch(frames: torch.Tensor, p: int) -> torch.Tensor:
    """[B, T, C, H, W] -> [B, T, H/p, W/p, p*p*C], channel (py p + px) C + c
    (thuml's ``reshape_patch`` on NHWC frames)."""
    b, t, c, hgt, wid = frames.shape
    x = frames.reshape(b, t, c, hgt // p, p, wid // p, p)
    return x.permute(0, 1, 3, 5, 4, 6, 2).reshape(b, t, hgt // p, wid // p,
                                                  p * p * c)


def reshape_patch_back(patches: torch.Tensor, p: int, c: int
                       ) -> torch.Tensor:
    """The inverse of ``reshape_patch``: [B, T, h, w, p*p*C] -> [B, T, C,
    h p, w p]."""
    b, t, hh, ww, _ = patches.shape
    x = patches.reshape(b, t, hh, ww, p, p, c).permute(0, 1, 6, 2, 4, 3, 5)
    return x.reshape(b, t, c, hh * p, ww * p)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with an OIHW kernel (odd size, no bias) in
    x's dtype; channels-last operands give an NHWC-contiguous result."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return out.permute(0, 2, 3, 1)


CELL_CONVS = ("conv_x", "conv_h", "conv_m", "conv_o", "conv_last")


class SpatioTemporalLSTMCell(nn.Module):
    """The ST-LSTM cell's parameters (thuml's names and shapes, no bias, no
    layer norm); ``st_lstm_step`` runs it on cast weights."""

    def __init__(self, in_channel: int, num_hidden: int, filter_size: int):
        super().__init__()
        k, pad = filter_size, filter_size // 2
        self.conv_x = nn.Conv2d(in_channel, 7 * num_hidden, k, padding=pad,
                                bias=False)
        self.conv_h = nn.Conv2d(num_hidden, 4 * num_hidden, k, padding=pad,
                                bias=False)
        self.conv_m = nn.Conv2d(num_hidden, 3 * num_hidden, k, padding=pad,
                                bias=False)
        self.conv_o = nn.Conv2d(2 * num_hidden, num_hidden, k, padding=pad,
                                bias=False)
        self.conv_last = nn.Conv2d(2 * num_hidden, num_hidden, 1, bias=False)


def st_lstm_step(w: Sequence[torch.Tensor], x, h, c, m,
                 deltas: bool = True):
    """One ST-LSTM cell-step on NHWC tensors with the cell's cast weights
    ``w`` (``CELL_CONVS`` order): (h', c', m', delta_c, delta_m); the deltas
    are None where neither ``deltas`` nor a gradient asks for them."""
    mem, c_new, m_new, d_c, d_m, oxh = st_gates(
        conv_nhwc(x, w[0]), conv_nhwc(h, w[1]), conv_nhwc(m, w[2]), c, m,
        deltas)
    h_new = st_hidden(oxh, conv_nhwc(mem, w[3]), conv_nhwc(mem, w[4]))
    return h_new, c_new, m_new, d_c, d_m


def decoupling_loss(deltas: List[Tuple[torch.Tensor, torch.Tensor]],
                    adapter: torch.Tensor) -> torch.Tensor:
    """The mean over (step, layer) pairs, rows and channels of |cos| between
    ``adapter(delta_c)`` and ``adapter(delta_m)``, each over its pixels.

    ``deltas``: every pair's (delta_c, delta_m), NHWC [B, H, W, F];
    ``adapter``: the 1 x 1 kernel [F, F, 1, 1]. All 2N deltas are stacked,
    run through one GEMM, and reduced at once in float32; the cosine is the
    dot product over the norms, each norm at least 1e-12 (thuml normalises
    each vector with ``F.normalize``, then takes ``cosine_similarity``:
    the same cosine)."""
    n = len(deltas)
    fw = adapter.shape[0]
    stacked = torch.stack([d for d, _ in deltas] + [d for _, d in deltas])
    b = stacked.shape[1]
    a = (stacked.reshape(-1, fw) @ adapter.reshape(fw, fw).t()).float()
    a = a.reshape(2, n * b, -1, fw)                 # [c|m, pair-row, px, F]
    dot = (a[0] * a[1]).sum(dim=1)
    norm = a.square().sum(dim=2).sqrt().clamp_min(1e-12)
    return (dot / (norm[0] * norm[1])).abs().mean()


class PredRNN(nn.Module):
    """frames [B, T_in, C, H, W] -> predictions [B, T_out, C, H, W] float32
    (``forward``); ``loss`` trains on (inputs, targets, mask)."""

    loss_name = "Loss"          # MSE + beta x decoupling, for the logs

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128, 128),
                 input_frames: int = 10, output_frames: int = 10,
                 in_channels: int = 1, kernel_size: int = 5,
                 patch_size: int = 4, decouple_beta: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(set(hidden_dims)) != 1:
            raise ValueError(f"PredRNN needs every hidden width equal (the "
                             f"memory m and the shared adapter pass between "
                             f"layers), got {tuple(hidden_dims)}")
        if kernel_size % 2 == 0:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.hidden_dims = tuple(hidden_dims)
        self.input_frames = input_frames
        self.output_frames = output_frames
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.decouple_beta = decouple_beta
        self.dtype = dtype
        fw = hidden_dims[0]
        frame_channel = patch_size * patch_size * in_channels
        self.cell_list = nn.ModuleList(
            SpatioTemporalLSTMCell(frame_channel if i == 0 else fw, fw,
                                   kernel_size)
            for i in range(len(hidden_dims)))
        self.conv_last = nn.Conv2d(fw, frame_channel, 1, bias=False)
        self.adapter = nn.Conv2d(fw, fw, 1, bias=False)

    @property
    def steps(self) -> int:
        return self.input_frames + self.output_frames - 1

    def _weights(self) -> List[torch.Tensor]:
        """Every conv kernel (the model's parameters): each cell's in
        ``CELL_CONVS`` order, then the head's and the adapter's."""
        return [getattr(cell, n).weight for cell in self.cell_list
                for n in CELL_CONVS] + [self.conv_last.weight,
                                        self.adapter.weight]

    def _cast_weights(self, dtype, weights=None):
        """``weights`` (None: ``_weights()``) in ``dtype`` and the
        channels-last layout, once per forward pass: ([per cell,
        CELL_CONVS order], head, adapter)."""
        ws = [w.to(dtype=dtype, memory_format=torch.channels_last)
              for w in (self._weights() if weights is None else weights)]
        n = len(CELL_CONVS)
        cells = [ws[i * n:(i + 1) * n] for i in range(len(self.cell_list))]
        return cells, ws[-2], ws[-1]

    def rollout(self, frames: torch.Tensor, mask: Optional[torch.Tensor],
                decouple: bool, weights=None):
        """The recurrence over ``steps`` steps: (predictions [steps, B, h, w,
        p*p*C] in the compute dtype, the decoupling loss or None).

        ``frames`` [B, T, C, H, W] with T >= 1; ``mask`` [steps - 1, B] bool
        (then T must cover every step it reads, T >= steps) or None (the
        input frames while there are any, then the model's own
        predictions). ``weights``: ``_weights()``'s in its order, or
        None."""
        b, t_given, c, hgt, wid = frames.shape
        p = self.patch_size
        if hgt % p or wid % p or c != self.in_channels:
            raise ValueError(f"frames [B, T, {self.in_channels}, H, W] with H "
                             f"and W divisible by the patch {p}, got "
                             f"{tuple(frames.shape)}")
        if mask is not None and (tuple(mask.shape) != (self.steps - 1, b)
                                 or t_given < self.steps):
            raise ValueError(f"mask must be [{self.steps - 1}, {b}] with at "
                             f"least {self.steps} frames, got "
                             f"{tuple(mask.shape)} with {t_given}")
        cdtype = self.dtype or frames.dtype
        x_seq = reshape_patch(frames, p).to(cdtype).transpose(0, 1)
        x_seq = x_seq.contiguous()                       # [T, B, h, w, pC]
        if mask is not None:
            mask = mask.to(frames.device)
        n_in = t_given if mask is not None else min(t_given,
                                                    self.input_frames)
        cells, head, adapter = self._cast_weights(cdtype, weights)
        zero = torch.zeros(x_seq.shape[1:4] + (self.hidden_dims[0],),
                           dtype=cdtype, device=frames.device)
        h = [zero] * len(cells)
        c_state = [zero] * len(cells)
        m = zero
        gens, deltas = [], []
        x_gen = None
        with span("predrnn.rollout"):
            for t in range(self.steps):
                if t == 0:
                    net = x_seq[0]
                elif mask is not None:
                    net = torch.where(mask[t - 1][:, None, None, None],
                                      x_seq[t], x_gen)
                else:
                    net = x_seq[t] if t < n_in else x_gen
                for li, w in enumerate(cells):
                    h[li], c_state[li], m, d_c, d_m = st_lstm_step(
                        w, net, h[li], c_state[li], m, decouple)
                    if decouple:
                        deltas.append((d_c, d_m))
                    net = h[li]
                x_gen = conv_nhwc(net, head)
                gens.append(x_gen)
        loss = None
        if decouple:
            with span("predrnn.decouple"):
                loss = decoupling_loss(deltas, adapter)
        return torch.stack(gens), loss

    def _outputs(self, gens: torch.Tensor) -> torch.Tensor:
        """The last ``output_frames`` predictions as [B, T_out, C, H, W]
        float32."""
        out = gens[-self.output_frames:].transpose(0, 1).float()
        return reshape_patch_back(out, self.patch_size, self.in_channels)

    def forward(self, frames: torch.Tensor,
                targets: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The ``output_frames`` predictions after ``frames`` [B, T_in, C, H,
        W] (a request: thuml's test mask). With ``targets`` [B, T_out, C, H,
        W] and ``mask`` [steps - 1, B], the rollout of reverse scheduled
        sampling over the whole sequence."""
        if frames.shape[1] != self.input_frames:
            raise ValueError(f"expected a {self.input_frames}-frame input "
                             f"window (input_frames), got {frames.shape[1]}")
        if targets is not None and mask is not None:
            frames = torch.cat([frames, targets.to(frames.dtype)], dim=1)
        else:
            mask = None
        gens, _ = self.rollout(frames, mask, decouple=False)
        return self._outputs(gens)

    def loss(self, inputs: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None):
        """(MSE of every prediction against frames 1.. + decouple_beta x the
        decoupling loss, the last ``output_frames`` predictions [B, T_out, C,
        H, W] float32) on the sequence concat(inputs, targets).

        With gradients on CUDA tensors, from the second call at a shape on,
        replayed from CUDA graphs (``models/loss_graphs.py``)."""
        return loss_graphs(self, self._weights(), self._loss, inputs,
                           targets, mask, key=(self.decouple_beta,))

    def teacher_probs(self, p: float) -> torch.Tensor:
        """Each mask entry's probability of the true frame at the trainer's
        teacher-forcing probability ``p``: [steps - 1], 1 - p / 2 in the
        input phase, p / 2 after it (reverse scheduled sampling: true frames
        give way to the model's own predictions in the input phase as p
        decays, and take over the decode phase's)."""
        return torch.tensor([1.0 - p / 2] * (self.input_frames - 1)
                            + [p / 2] * (self.output_frames - 1))

    def _loss(self, inputs, targets, mask, weights=None):
        """``loss``, eagerly (on ``weights`` in ``_weights()``'s order, or
        the parameters)."""
        frames = torch.cat([inputs, targets.to(inputs.dtype)], dim=1)
        gens, dec = self.rollout(frames, mask, decouple=True,
                                 weights=weights)
        target = reshape_patch(frames[:, 1:self.steps + 1].float(),
                               self.patch_size).transpose(0, 1)
        mse = (gens.float() - target).square().mean()
        return mse + self.decouple_beta * dec, self._outputs(gens)
