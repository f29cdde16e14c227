"""Host utilities: byte-level (de)serialization (``serde.py``), the
prover's spans (``profiler.py``) and the kernel-health report
(``kernel_health.py``)."""
