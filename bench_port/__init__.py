"""The benchmark of the PyTorch and CUDA port `stablemtl_tpu_torch`
(README in PERF.md). It imports neither JAX nor the JAX package."""
