"""Primitives: NHWC conv helpers (``nn``), the ConvLSTM cell (``convlstm``) and
the CUDA kernels with their plain versions (``kernels``)."""
