"""The benchmark of the PyTorch and CUDA port (``pl_convlstm_gan_tpu_torch``)
on an NVIDIA H100: ``python -m bench_cuda.run --workload <config>.<mix>
--seed <n> --seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the
checkout root names the cells."""
