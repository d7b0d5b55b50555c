"""Profiling (``profiling``) and the trainers' plots (``visualization``),
counterparts of the JAX package's ``utils/``. matplotlib is imported inside
each plot function, so importing this package loads none of it."""
from .profiling import Timer, benchmark_chained, benchmark_fn
from .visualization import (plot_sequence_comparison, plot_stations_vs_pred,
                            plot_training_curves)

__all__ = ["plot_sequence_comparison", "plot_stations_vs_pred",
           "plot_training_curves", "Timer", "benchmark_chained", "benchmark_fn"]
