"""Command line of the port: ``python -m pl_convlstm_gan_tpu_torch``.

    python -m pl_convlstm_gan_tpu_torch --config nowcast_128_pallas \\
        --mode train [--resume]
    python -m pl_convlstm_gan_tpu_torch --config gan_64 --mode train
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128_pallas \\
        --mode eval [--checkpoint <dir>]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode predict \\
        --input frames.npy --checkpoint params.npz [--output-frames N]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode stream \\
        --input frames.npy --checkpoint params.npz [--horizons 10,30]

Train mode, the default (as in the JAX CLI), runs ``SequenceTrainer``
(forecaster and GAN families); ``--resume``
continues from ``<output_dir>/latest``, else ``best_model``, recovering a
checkpoint a crash left at ``.pending`` or ``.old``. Eval mode restores a
checkpoint (default ``<output_dir>/best_model``) and prints the test-split
metrics. Predict and stream restore the weights (a ``.npz`` of flattened
flax params, a torch ``.pt`` state_dict, or a checkpoint directory of the
trainer, of a GAN run its generator; default ``<output_dir>/best_model``) and read frames from a
``.npy``, or a ``.npz`` with a ``frames`` key. Predict mode runs the
forecaster on [B,T_in,C,H,W] and writes the predictions [B,T_out,C,H,W] as
a ``.npy``. Stream mode feeds [T,C,H,W] (one stream) or [B,T,C,H,W] (B
streams) one frame at a time through ``StreamingForecaster`` and writes an
``.npz`` with ``nowcasts`` [B,T,C,H,W] and one ``forecast_<h>`` [B,h,C,H,W]
per horizon, branched from the state after the last frame. Every mode runs
on the GPU unless ``--device cpu`` is given. Export and the other modes are
not ported yet.
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


def _train(config, args):
    from .train.checkpoint import recover_checkpoint_dir
    from .train.sequence_trainer import SequenceTrainer

    if args.resume and not config.training.resume_from:
        for name in ("latest", "best_model"):
            ckpt = os.path.join(config.output.output_dir, name)
            if recover_checkpoint_dir(ckpt):
                config.training.resume_from = ckpt
                print(f"Resuming from {ckpt}")
                break
        else:
            print("--resume: no checkpoint found, starting fresh")
    return SequenceTrainer(config=config, device=args.device).train()


def _evaluate(config, args):
    from .train.sequence_trainer import SequenceTrainer

    trainer = SequenceTrainer(config=config, device=args.device)
    trainer.setup_data()
    trainer.setup_model()
    trainer.restore(args.checkpoint or os.path.join(config.output.output_dir,
                                                    "best_model"))
    metrics = trainer.evaluate_test()
    print(f"Test metrics: {metrics}")
    return metrics


def _make_parent(path):
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def main(argv=None):
    """Run one mode; returns the history (train) or the test metrics
    (eval)."""
    from .config import load_config
    from .predict import load_predictor

    parser = argparse.ArgumentParser(
        prog="python -m pl_convlstm_gan_tpu_torch",
        description="pl-convlstm-gan forecaster and GAN training and "
                    "inference on PyTorch/CUDA")
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
                             ".npz with a 'frames' key")
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

    config = load_config(args.config)
    training = args.mode in ("train", "eval")
    config.validate(training=training)
    if training:
        return _train(config, args) if args.mode == "train" else \
            _evaluate(config, args)
    if config.model.family not in ("forecaster", "gan"):
        raise SystemExit(f"the port serves the forecaster/gan families, not "
                         f"{config.model.family!r}")
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
    frames = _load_frames(args.input)
    predict = load_predictor(config, args.checkpoint,
                             output_frames=args.output_frames,
                             device=args.device)
    pred = predict(frames).cpu().numpy()
    _make_parent(out_path)
    np.save(out_path, pred)
    print(f"Predictions {pred.shape} saved to {out_path}")


if __name__ == "__main__":
    main()
