"""Inference: build the model from a config, load its weights, and return a
predict function. Counterpart of the JAX package's ``predict.py`` for the
forecaster family.

Usage:
    from pl_convlstm_gan_tpu_torch.predict import load_predictor
    predict = load_predictor(config, "params.npz")     # runs on the GPU
    future = predict(past_frames)    # [B,T_in,1,H,W] -> [B,T_out,1,H,W] f32

Checkpoints are a ``.npz`` of the flattened flax params (see ``weights.py``;
the README shows how to write one from a JAX checkpoint), a torch ``.pt``
state_dict, or a checkpoint directory that the port's trainer wrote
(``<output_dir>/best_model`` or ``latest``). Entry points run on the GPU
unless the caller passes ``device="cpu"``; with no CUDA device and no such
request they raise.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from .config import Config, convlstm_cell_impl
from .models import ConvLSTMForecaster, Discriminator
from .ops.kernels.rollout_kernel import pack_weights, rollout_kernel
from .weights import flax_to_state_dict

ROLLOUT_IMPLS = ("auto", "torch", "kernel")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, and raises when
    there is none (an entry point never carries on on the CPU unasked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                               "device='cpu' to run its plain path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def compute_dtype(config: Config) -> torch.dtype:
    return (torch.bfloat16 if config.precision.compute_dtype == "bfloat16"
            else torch.float32)


def build_model(config: Config, output_frames: int = 0) -> ConvLSTMForecaster:
    """The (randomly initialised) module a config describes. ``output_frames``
    overrides the rollout horizon: the recurrent weights do not depend on it.
    ``model.convlstm_impl`` picks the cells' step (``convlstm_cell_impl``)."""
    mc = config.model
    if mc.family not in ("forecaster", "gan"):
        raise NotImplementedError(
            f"model family {mc.family!r} is not ported yet; the port serves "
            f"the forecaster (and the GAN's forecaster generator)")
    dtype = torch.bfloat16 if compute_dtype(config) == torch.bfloat16 else None
    return ConvLSTMForecaster(
        hidden_dims=tuple(mc.hidden_dims), input_frames=mc.input_frames,
        output_frames=output_frames or mc.output_frames,
        in_channels=mc.in_channels, kernel_size=mc.kernel_size, dtype=dtype,
        convlstm_impl=convlstm_cell_impl(mc.convlstm_impl))


def build_discriminator(config: Config) -> Discriminator:
    """The GAN family's (randomly initialised) discriminator: features
    ``model.disc_features``, the config's compute dtype."""
    dtype = torch.bfloat16 if compute_dtype(config) == torch.bfloat16 else None
    return Discriminator(config.model.in_channels,
                         tuple(config.model.disc_features), dtype)


def load_state_dict(checkpoint_path: str) -> dict:
    """A ``.npz`` of flattened flax params, a torch ``.pt`` state_dict, or a
    checkpoint directory written by the port's trainer (``best_model``,
    ``latest``): its ``params``, or for a GAN checkpoint ``gen_params`` (the
    generator is the deployed model), as the JAX ``restore_params``."""
    if os.path.isdir(checkpoint_path):
        from .train.checkpoint import restore_checkpoint
        device_state = restore_checkpoint(checkpoint_path)[0]
        params = device_state.get("params", device_state.get("gen_params"))
        if params is None:
            raise ValueError(f"no params/gen_params in checkpoint "
                             f"{checkpoint_path}")
        return params
    if checkpoint_path.endswith(".npz"):
        with np.load(checkpoint_path) as data:
            return flax_to_state_dict({k: data[k] for k in data.files})
    if checkpoint_path.endswith(".pt"):
        return torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    raise ValueError(f"checkpoint must be a .npz of flax params, a .pt "
                     f"state_dict or a checkpoint directory of the port's "
                     f"trainer, got {checkpoint_path!r}")


def build_predict_fn(config: Config, checkpoint_path: str,
                     output_frames: int = 0, rollout_impl: str = "",
                     device=None) -> Callable:
    """Load the weights and return fn(frames [B,T_in,C,H,W] tensor on the
    device) -> [B,T_out,C,H,W] float32.

    ``rollout_impl`` (default: the config's) picks the path: 'kernel' = the
    CUDA kernels K1 and K2 launched step by step (``rollout_kernel``; on CPU
    tensors each wrapper runs its plain version); 'torch' = the plain
    ``ConvLSTMForecaster.forward``; 'auto' = 'kernel' on a GPU, else 'torch'."""
    dev = resolve_device(device)
    impl = rollout_impl or config.model.rollout_impl
    if impl not in ROLLOUT_IMPLS:
        raise ValueError(f"Unknown rollout_impl: {impl!r} (valid: "
                         f"{', '.join(ROLLOUT_IMPLS)})")
    model = build_model(config, output_frames)
    model.load_state_dict(load_state_dict(checkpoint_path))
    model.to(dev).eval()
    t_in, t_out = model.input_frames, model.output_frames

    if impl == "kernel" or (impl == "auto" and dev.type == "cuda"):
        cdtype = compute_dtype(config)
        weights = pack_weights(model.state_dict(), cdtype)

        def fn(frames):
            if frames.shape[1] != t_in:
                raise ValueError(f"expected a {t_in}-frame input window "
                                 f"(model.input_frames), got {frames.shape[1]}")
            return rollout_kernel(weights, frames, t_out, cdtype)
        return fn
    return model


def load_predictor(config: Config, checkpoint_path: str,
                   output_frames: int = 0, device=None) -> Callable:
    """``build_predict_fn`` behind a function that takes numpy arrays or
    tensors, moves them to the device, and runs without autograd.

    predict(frames [B,T_in,C,H,W]) -> [B,T_out,C,H,W] float32 tensor on the
    device; ``output_frames`` serves another horizon than the config's."""
    dev = resolve_device(device)
    fn = build_predict_fn(config, checkpoint_path, output_frames, device=dev)

    def predict(frames):
        frames = torch.as_tensor(np.asarray(frames) if not isinstance(
            frames, torch.Tensor) else frames).to(dev, torch.float32)
        with torch.inference_mode():
            return fn(frames)
    return predict
