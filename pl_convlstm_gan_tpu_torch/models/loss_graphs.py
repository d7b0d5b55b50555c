"""A model's training loss replayed as CUDA graphs, for every family that
trains through ``train/steps.forecaster_train_step`` (``ConvLSTMForecaster``
and ``PredRNN``).

A train step at the port's widths is ~2,000 (the nowcaster) to ~2,700
(PredRNN) launches. Issued one by one they take the host longer than the
device takes to run them, and the step times the host. So ``model.loss``
with gradients on CUDA tensors goes through ``loss_graphs``: the first call
at a key runs eagerly and warms every kernel, the second captures the
forward (the model's loss and predictions) as one graph and the backward to
the parameters' gradients as another, in one memory pool, and every later
call copies its inputs into the graphs' buffers and replays them. The graphs
run the same kernels (K1, K6, K7 and cuDNN's convs) on the same addresses,
so a replayed step computes what the eager one computes.

The mechanism is generic: a model hands over its differentiable weights in
a fixed order and a function ``loss(inputs, targets, extra, weights)`` that
computes its (loss, predictions) on those weights (None: its parameters).
``extra`` is PredRNN's mask or the forecaster's ``teacher_draws``.

When the graphs engage (``engages``), decided from what the call can
observe: gradients are enabled, the inputs are CUDA tensors that need no
gradient, some weight needs one, no capture is under way, no weight is a
tensor-parallel shard (``tp_sharded``: the cells' all-gathers stay eager)
and the model does not run under remat (``model.remat``: checkpoint's
recompute re-enters autograd inside the backward, which a captured
backward cannot replay). Everything else runs eagerly: the CPU, ``no_grad``,
serving, evaluation, TP and remat. A call that engages still runs eagerly
where its key is new (the warm-up) or where a replayed forward's backward
has not run yet while its loss is alive (a second forward would overwrite
what that backward reads).

The key is the shapes and dtypes of the inputs, the targets and ``extra``
(or its absence), the device, the weights' addresses and whether each needs
a gradient, and what the model adds (PredRNN: its ``decouple_beta``). One
key is kept per model: a new key drops the old graphs.

Counters (``utils.profiling.counters()``): ``loss_graphs.captures``,
``loss_graphs.replays`` and ``loss_graphs.eager`` (calls with gradients on
CUDA tensors that ran eagerly: the warm-up, TP, remat, a pending backward).
A capture launches nothing, so it takes back what its kernels counted; a
replay adds what its capture counted (``add_counts``), so K1's, K6's and
K7's launch counters read the same on a replayed step as on an eager one.

Tracing: a replayed forward is the span ``plcg.loss_graphs.replay`` (inside
``plcg.train.forward`` in a train step; the backward's replay runs on
autograd's thread, inside ``plcg.train.backward``).
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.kernels.convlstm_kernel import reserve_capture_workspace
from ..utils.profiling import add_counts, counters, span

# model -> {key: _LossGraphs, or None once the key ran eagerly}
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def engages(model, weights: Sequence[torch.Tensor], inputs: torch.Tensor,
            targets: torch.Tensor) -> bool:
    """Whether ``model``'s loss on these operands may run through CUDA
    graphs (the module docstring's rule)."""
    return (torch.is_grad_enabled() and inputs.is_cuda
            and not (inputs.requires_grad or targets.requires_grad)
            and any(w.requires_grad for w in weights)
            and not torch.cuda.is_current_stream_capturing()
            and not any(getattr(w, "tp_sharded", False) for w in weights)
            and not getattr(model, "remat", False))


def loss_graphs(model, weights: Sequence[torch.Tensor], loss: Callable,
                inputs: torch.Tensor, targets: torch.Tensor,
                extra: Optional[torch.Tensor] = None, key: tuple = ()):
    """(loss, predictions) of ``loss(inputs, targets, extra, weights)``:
    replayed from CUDA graphs where they engage and the key has run before,
    else eagerly on the parameters (``loss(inputs, targets, extra, None)``).
    ``weights``: the model's differentiable weights in a fixed order (the
    order ``loss`` reads them in); ``key``: what else decides the graphs."""
    graphs = _graphs(model, weights, loss, inputs, targets, extra, key)
    if graphs is None:
        if torch.is_grad_enabled() and inputs.is_cuda:
            loss_graphs.eager += 1
        return loss(inputs, targets, extra, None)
    loss_graphs.replays += 1
    return graphs(inputs, targets, extra)


loss_graphs.captures = 0
loss_graphs.replays = 0
loss_graphs.eager = 0


def _graphs(model, weights, loss, inputs, targets, extra, key
            ) -> Optional["_LossGraphs"]:
    """The captured graphs for these operands, capturing them at the key's
    second call; None where the call runs eagerly."""
    if not engages(model, weights, inputs, targets):
        return None
    full = (tuple(inputs.shape), inputs.dtype, tuple(targets.shape),
            targets.dtype, None if extra is None else
            (tuple(extra.shape), extra.dtype), inputs.device, key,
            tuple((w.data_ptr(), w.requires_grad) for w in weights))
    cache = _GRAPHS.setdefault(model, {})
    if full not in cache:
        cache.clear()                   # one shape and one set of weights
        cache[full] = None
        return None
    graphs = cache[full]
    if graphs is None:
        graphs = cache[full] = _LossGraphs(weights, loss, inputs, targets,
                                           extra)
        loss_graphs.captures += 1
    return None if graphs.pending() else graphs


class _LossGraphs:
    """``loss`` at one key as two CUDA graphs in one memory pool: the
    forward, from copies of the inputs to the loss and predictions, and the
    backward, from the loss's gradient to the weights'. Replaying them needs
    the weights where they were at capture (the key holds their addresses)
    and runs the forward and the backward in turn: a backward replay reads
    what the last forward replay left in the pool.

    The capture runs on leaves of its own that share the weights' storage,
    so that it builds no edge to the parameters' gradient accumulators: one
    that an earlier eager step's graph still holds (its loss or predictions
    kept alive) belongs to the default stream, and reaching it from the
    capture's stream would end the capture. ``extra`` becomes a buffer on
    the device, so that no copy from the host's memory is captured.

    K6's launches in the captured backward use a workspace reserved for
    this capture before it begins (``reserve_capture_workspace``) and kept
    here as long as the graphs: no eager launch reads it."""

    def __init__(self, weights, loss, inputs, targets, extra):
        self.params = [w for w in weights if w.requires_grad]
        leaves = [w.detach().requires_grad_(w.requires_grad)
                  for w in weights]
        self.static = [t.detach().clone() for t in (inputs, targets)]
        self.static.append(None if extra is None
                           else extra.to(inputs.device, copy=True))
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(inputs.device)     # the capture's
        self.workspace = reserve_capture_workspace(inputs.device,
                                                   self.stream.cuda_stream)
        before = counters()
        with torch.cuda.graph(self.fwd, stream=self.stream):
            total, pred = loss(*self.static, leaves)
        mid = counters()
        self.grad_total = torch.empty_like(total)
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool(),
                              stream=self.stream):
            self.grads = torch.autograd.grad(
                total, [w for w in leaves if w.requires_grad],
                self.grad_total, allow_unused=True)
        after = counters()
        # a capture launches nothing: what it counted is what a replay runs
        add_counts({k: before[k] - after[k] for k in after})
        self.fwd_counts = {k: mid[k] - before[k] for k in mid}
        self.bwd_counts = {k: after[k] - mid[k] for k in after}
        self.total, self.pred = total.detach(), pred.detach()
        self._live = None               # the loss of a pending backward

    def pending(self) -> bool:
        return self._live is not None and self._live() is not None

    def __call__(self, inputs, targets, extra):
        total, pred = _Replay.apply(self, inputs, targets, extra,
                                    *self.params)
        self._live = weakref.ref(total)
        return total, pred

    def forward(self, inputs, targets, extra):
        for buf, t in zip(self.static, (inputs, targets, extra)):
            if buf is not None and buf.data_ptr() != t.data_ptr():
                buf.copy_(t)
        with span("loss_graphs.replay"):
            self.fwd.replay()
        add_counts(self.fwd_counts)
        return self.total.clone(), self.pred.clone()

    def backward(self, g_total) -> Tuple[Optional[torch.Tensor], ...]:
        if self._live is None:
            raise RuntimeError("a captured backward replayed twice after one "
                               "forward")
        self._live = None
        self.grad_total.copy_(g_total)
        self.bwd.replay()
        add_counts(self.bwd_counts)
        return tuple(None if g is None else g.clone() for g in self.grads)


class _Replay(torch.autograd.Function):
    """apply(graphs, inputs, targets, extra, *params) -> (loss,
    predictions): the forward graph's replay, whose backward replays the
    backward graph into the parameters' gradients (the predictions take
    none)."""

    @staticmethod
    def forward(ctx, graphs: _LossGraphs, inputs, targets, extra, *params):
        ctx.graphs = graphs
        total, pred = graphs.forward(inputs, targets, extra)
        ctx.mark_non_differentiable(pred)
        return total, pred

    @staticmethod
    def backward(ctx, g_total, g_pred):
        return (None, None, None, None) + ctx.graphs.backward(g_total)
