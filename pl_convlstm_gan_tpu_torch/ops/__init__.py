"""Primitives: NHWC conv helpers (``nn``), the ConvLSTM cell (``convlstm``),
the Generator's CoordConv channels (``coords``), pixel shuffle
(``pixel_shuffle``) and resizes (``resize``), and the CUDA kernels with
their plain versions (``kernels``)."""
