"""Command line of the port: ``python -m pl_convlstm_gan_tpu_torch``.

    python -m pl_convlstm_gan_tpu_torch --config default --mode train \\
        [--resume]
    python -m pl_convlstm_gan_tpu_torch --config default --mode predict \\
        --input lr.npz --checkpoint output/best_model
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128_pallas \\
        --mode train [--resume]
    python -m pl_convlstm_gan_tpu_torch --config gan_64 --mode train
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128_pallas \\
        --mode eval [--checkpoint <dir>]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode predict \\
        --input frames.npy --checkpoint params.npz [--output-frames N]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode stream \\
        --input frames.npy --checkpoint params.npz [--horizons 10,30]

Train mode, the default (as in the JAX CLI), runs ``Trainer`` (the
Generator family) or ``SequenceTrainer`` (forecaster and GAN); ``--resume``
continues from ``<output_dir>/latest``, else ``best_model``, recovering a
checkpoint a crash left at ``.pending`` or ``.old``. Eval mode restores a
checkpoint (default ``<output_dir>/best_model``) and prints the test-split
metrics. Predict and stream restore the weights (a ``.npz`` of flattened
flax params, a torch ``.pt`` state_dict, a reference Generator ``.pth``,
or a checkpoint directory of the trainer, of a GAN run its generator;
default ``<output_dir>/best_model``) and read frames from a ``.npy``, or a
``.npz`` with a ``frames`` key. Predict mode runs the
forecaster on [B,T_in,C,H,W] and writes the predictions [B,T_out,C,H,W] as
a ``.npy``; for the Generator it reads an ``.npz`` of ``rain_lr``
[B,T,1,H,W], ``dem`` and ``lu`` (whose channel count sets the LUCC class
count) and writes [B,T,1,H',W']. Stream mode (sequence families only)
feeds [T,C,H,W] (one stream) or [B,T,C,H,W] (B streams) one frame at a
time through ``StreamingForecaster`` and writes an
``.npz`` with ``nowcasts`` [B,T,C,H,W] and one ``forecast_<h>`` [B,h,C,H,W]
per horizon, branched from the state after the last frame. Every mode runs
on the GPU unless ``--device cpu`` is given. Export and the other modes are
not ported yet.

Data parallelism: launched by ``torchrun`` (or with the JAX package's
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), every rank
runs this CLI; it joins the process group before anything touches the
device (``parallel.mesh.maybe_init_distributed``: NCCL on the GPUs, each
rank on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``), the trainers
split each global batch over the ranks, rank 0 alone recovers a stranded
checkpoint (the others wait at a barrier), and rank 0 alone prints the
results and writes the outputs:

    torchrun --nproc_per_node 8 -m pl_convlstm_gan_tpu_torch \\
        --config dp_v5e16 --mode train [--resume]
    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config ci_smoke_seq --mode train --device cpu

Tensor parallelism (``mesh.model_axis`` > 1, the sequence families): the
trainers cut the world into data and model groups (``parallel/mesh.py``)
and shard every ConvLSTM cell over the model group; train and eval run on
every rank, checkpoints are canonical, so predict and stream (rank 0, one
process) read them as any other:

    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config tp_nowcast_128 --mode train [--resume]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _load_frames(path):
    """Frames array from a .npy, or a .npz with a 'frames' key."""
    data = np.load(path)
    return data["frames"] if isinstance(data, np.lib.npyio.NpzFile) else data


def _stream(config, args, out_path):
    import torch

    from .streaming import StreamingForecaster

    if args.checkpoint.endswith(".jaxexport"):
        raise SystemExit("a .jaxexport streaming artifact needs the export "
                         "slice, which the port has not ported yet: pass the "
                         "checkpoint's params as .npz or .pt")
    if args.horizons:
        try:
            horizons = tuple(int(h) for h in args.horizons.split(","))
        except ValueError:
            raise SystemExit(f"--horizons must be comma-separated ints, "
                             f"got {args.horizons!r}")
    else:
        horizons = (args.output_frames or config.model.output_frames,)
    frames = np.asarray(_load_frames(args.input), np.float32)
    if frames.ndim == 4:
        frames = frames[None]
    if frames.ndim != 5:
        raise SystemExit(f"stream input must be [T,C,H,W] or [B,T,C,H,W], "
                         f"got shape {frames.shape}")
    b, t, _, hgt, wid = frames.shape
    sf = StreamingForecaster.from_checkpoint(config, args.checkpoint,
                                             device=args.device)
    state = sf.init_state(b, hgt, wid)
    nowcasts = []
    for i in range(t):
        state, nowcast = sf.observe(state, frames[:, i])
        nowcasts.append(nowcast)
    out = {"nowcasts": torch.stack(nowcasts, 1).cpu().numpy()}
    for h in horizons:
        out[f"forecast_{h}"] = sf.forecast(state, h).cpu().numpy()
    _make_parent(out_path)
    np.savez(out_path, **out)
    shapes = {k: v.shape for k, v in out.items()}
    print(f"Streamed {t} frames x {b} stream(s): {shapes} saved to {out_path}")


def _trainer(config, args):
    """The family's trainer: ``Trainer`` (Generator) or
    ``SequenceTrainer``."""
    from .train import SequenceTrainer, Trainer
    cls = Trainer if config.model.family == "generator" else SequenceTrainer
    return cls(config=config, device=args.device)


def _train(config, args):
    from .parallel.mesh import print0
    from .train.checkpoint import recover_checkpoint_dir

    if args.resume and not config.training.resume_from:
        for name in ("latest", "best_model"):
            ckpt = os.path.join(config.output.output_dir, name)
            # rank 0 recovers; every rank then sees the same directory
            if recover_checkpoint_dir(ckpt):
                config.training.resume_from = ckpt
                print0(f"Resuming from {ckpt}")
                break
        else:
            print0("--resume: no checkpoint found, starting fresh")
    return _trainer(config, args).train()


def _evaluate(config, args):
    from .parallel.mesh import print0
    trainer = _trainer(config, args)
    dataset = trainer.setup_data()
    if config.model.family == "generator":
        trainer.setup_model(dataset)
    else:
        trainer.setup_model()
    trainer.restore(args.checkpoint or os.path.join(config.output.output_dir,
                                                    "best_model"))
    metrics = trainer.evaluate_test()
    print0(f"Test metrics: {metrics}")
    return metrics


def _make_parent(path):
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def main(argv=None):
    """Run one mode; returns the history (train) or the test metrics
    (eval)."""
    from .config import load_config
    from .parallel.mesh import is_primary, maybe_init_distributed
    from .predict import load_predictor

    parser = argparse.ArgumentParser(
        prog="python -m pl_convlstm_gan_tpu_torch",
        description="pl-convlstm-gan downscaling Generator, forecaster and "
                    "GAN training and inference on PyTorch/CUDA")
    parser.add_argument("--config", type=str, default="default",
                        help="configuration name (configs/<name>.yaml) or a "
                             "direct path to a .yaml file")
    parser.add_argument("--mode", choices=("train", "eval", "predict",
                                           "stream"), default="train",
                        help="train (the default, as in the JAX CLI); eval; "
                             "predict; stream")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="weights: .npz of flattened flax params, a "
                             "torch .pt state_dict or a checkpoint directory "
                             "of the trainer (default: <output_dir>/"
                             "best_model)")
    parser.add_argument("--resume", action="store_true",
                        help="train mode: resume from <output_dir>/latest "
                             "(or best_model) if present")
    parser.add_argument("--input", type=str, default=None,
                        help="input frames: [B,T_in,C,H,W] for predict, "
                             "[T,C,H,W] or [B,T,C,H,W] for stream; .npy, or "
                             ".npz with a 'frames' key; Generator predict: "
                             ".npz with rain_lr/dem/lu")
    parser.add_argument("--output", type=str, default=None,
                        help="output file (default: <output_dir>/"
                             "predictions.npy, or stream_out.npz)")
    parser.add_argument("--output-frames", type=int, default=0,
                        help="serve another rollout horizon than the "
                             "config's; 0 = config value")
    parser.add_argument("--horizons", type=str, default="",
                        help="stream mode: comma-separated forecast "
                             "horizons (default: --output-frames, else the "
                             "config's)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the GPU; 'cpu' runs the "
                             "plain path)")
    args = parser.parse_args(argv)
    if args.output_frames < 0:
        raise SystemExit("--output-frames must be non-negative "
                         "(0 = config value)")

    # before anything touches the device: joins the process group that
    # torchrun (or the JAX package's coordinator variables) names
    maybe_init_distributed(args.device)
    config = load_config(args.config)
    training = args.mode in ("train", "eval")
    config.validate(training=training)
    if training:
        return _train(config, args) if args.mode == "train" else \
            _evaluate(config, args)
    if not is_primary():
        return      # inference runs on rank 0 (load_predictor splits a
                    # batch over the GPUs itself: data_parallel)
    if args.mode == "stream" and config.model.family == "generator":
        raise SystemExit("stream mode needs a sequence family "
                         "(forecaster/gan), not the Generator")
    if not args.input:
        raise SystemExit(f"--mode {args.mode} requires --input")
    args.checkpoint = args.checkpoint or os.path.join(
        config.output.output_dir, "best_model")
    default_name = "predictions.npy" if args.mode == "predict" else "stream_out.npz"
    out_path = args.output or os.path.join(config.output.output_dir,
                                           default_name)
    if args.mode == "stream":
        _stream(config, args, out_path)
        return
    if config.model.family == "generator":
        data = np.load(args.input)
        if not isinstance(data, np.lib.npyio.NpzFile):
            raise SystemExit("generator-family predict needs an .npz with "
                             "rain_lr/dem/lu arrays")
        predict = load_predictor(config, args.checkpoint, device=args.device,
                                 lu_channels=data["lu"].shape[1])
        pred = predict(data["rain_lr"], data["dem"], data["lu"])
    else:
        predict = load_predictor(config, args.checkpoint,
                                 output_frames=args.output_frames,
                                 device=args.device)
        pred = predict(_load_frames(args.input))
    pred = pred.cpu().numpy()
    _make_parent(out_path)
    np.save(out_path, pred)
    print(f"Predictions {pred.shape} saved to {out_path}")


if __name__ == "__main__":
    main()
