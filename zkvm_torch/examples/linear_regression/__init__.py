"""The linear-regression-over-encrypted-inputs example on the port: a copy
of ``examples/linear_regression`` whose server proves with
:func:`zkvm_torch.vm.prove` on the card (``device="cpu"`` on the CPU)."""
