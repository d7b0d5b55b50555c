"""Experiments of the port on the GPU, each a counterpart of one in the
repository's ``experiments/`` (``tap_structure``: the P5 tap-structure
question on Hopper)."""
