"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- ``convlstm_kernel``: K1, the fused ConvLSTM cell step (csrc/convlstm_cell.cu),
  with or without the pre-activation z, and ``ConvLSTMCellFn``, the training
  step with its hand-written backward
- ``rollout_kernel``: K2, the conv head (csrc/conv_head.cu), and the
  free-running rollouts (cold, and warm from a carried state) and streaming
  observe that launch K1 and K2 step by step
- ``tap_structure_kernel``: K3 and K4, the tap-structure experiment's 9-tap
  and one-K1152 contractions (csrc/tap_structure.cu)
- ``build``: nvcc build of csrc/ and ctypes loading, at first use
"""
