"""The benchmark of the PyTorch and CUDA prover (``zkvm_torch``): see
:mod:`zkbench.run` and ``zkbench/README.md``."""
