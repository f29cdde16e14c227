"""Host utilities: byte-level (de)serialization (``serde.py``)."""
