"""Faults planted in the program, to show that ``correct`` comes out false
when the timed path is broken underneath: by the CPU tests at small sizes
and by ``calibrate`` on the chip at the cells' own. The benchmark's runs
never plant one.

- ``unchanged``: a step that returns its state unchanged (training: no
  update of the parameters or of Adam's state; streaming: ``observe``
  hands back the state it was given);
- ``half_batch``: the loss of half the batch, the mean taken over it;
- ``altered``: an answer altered where it is produced (the first frame of
  every forecast zeroed).
"""
from __future__ import annotations

import contextlib

TRAIN = ("unchanged", "half_batch")
STREAM = ("unchanged", "altered")


@contextlib.contextmanager
def planted(name):
    """Within: the program with fault ``name`` (None: as it is)."""
    if name is None:
        yield
        return
    from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
    from pl_convlstm_gan_tpu_torch.train import steps
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(steps, "_adam_update", lambda *a, **k: None)
        observe = StreamingForecaster.observe

        def same_state(self, state, frame):
            return state, observe(self, state, frame)[1]
        patch(StreamingForecaster, "observe", same_state)
    elif name == "half_batch":
        fl, gl = steps.forecaster_loss, steps.generator_loss

        def half_f(model, inputs, targets, teacher_draws=None):
            h = max(inputs.shape[0] // 2, 1)
            return fl(model, inputs[:h], targets[:h], teacher_draws)

        def half_g(model, batch, loss_cfg, group=None):
            b = batch[0].shape[0]
            h = max(b // 2, 1)
            total, parts, pred, scale = gl(
                model, tuple(t[:h] for t in batch), loss_cfg, group)
            return total, parts, pred.repeat(2, 1, 1, 1, 1)[:b], scale
        patch(steps, "forecaster_loss", half_f)
        patch(steps, "generator_loss", half_g)
    elif name == "altered":
        forecast = StreamingForecaster.forecast

        def zero_first(self, state, horizon):
            out = forecast(self, state, horizon).clone()
            out[:, 0] = 0
            return out
        patch(StreamingForecaster, "forecast", zero_first)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
