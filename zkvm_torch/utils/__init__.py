"""Host utilities: byte-level (de)serialization (``serde.py``), the
per-phase profiler (``profiler.py``) and the kernel-health report
(``kernel_health.py``)."""
