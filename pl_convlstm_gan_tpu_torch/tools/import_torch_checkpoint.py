"""Carry the reference PyTorch Generator's weights into the port and back.

The reference saves ``best_model.pth`` bundles with a ``model_state_dict``
(the reference trainer, ``src/training/trainer.py:410-417``) and ships no
loader. The JAX package's tool of this name maps that state_dict onto its
flax params; the port's does the same onto its own ``state_dict``, whose
module names are the flax paths (``weights.py``):

reference module                         -> the port's module
---------------------------------------------------------------------------
init_conv.{weight,bias}                  -> init_conv
cell{k}.conv.{weight,bias}               -> recurrence.cell{k}
dem_attn.conv.0 / .2                     -> dem_attn.conv_reduce / conv_gate
lu_attn.conv.0 / .2                      -> lu_attn.conv_reduce / conv_gate
upsample_blocks.{i}.conv                 -> upsample_{i}.conv
post_process.0 / .2                      -> post_conv1 / post_conv2

Both sides keep conv weights OIHW and the gate order i|f|o|g, so values
cross unchanged. ``weights.load_reference_pth`` reads a ``.pth``;
``weights.reference_state_dict`` is the inverse (the JAX tool's
``export_state_dict``), for handing weights back to the reference.

Usage:
    python -m pl_convlstm_gan_tpu_torch.tools.import_torch_checkpoint \
        --pth best_model.pth --out converted_ckpt
writes a checkpoint directory of the port's trainer (``params``), which
``--checkpoint`` of the CLI and ``predict.load_predictor`` read.
"""
from __future__ import annotations

import argparse

from ..weights import load_reference_pth, reference_state_dict

__all__ = ["load_reference_pth", "reference_state_dict", "main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pth", required=True, help="reference best_model.pth")
    ap.add_argument("--out", required=True,
                    help="output checkpoint directory (the port's format)")
    args = ap.parse_args(argv)

    from ..train.checkpoint import CheckpointWriter

    writer = CheckpointWriter()
    writer.save(args.out, {"params": load_reference_pth(args.pth)},
                {"source": args.pth, "format": "imported-torch"})
    writer.wait()
    print(f"converted {args.pth} -> {args.out}")


if __name__ == "__main__":
    main()
