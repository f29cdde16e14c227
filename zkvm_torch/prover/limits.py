"""Trace-length limits of the port's provers, and the threshold of the
chunked stage forms.

Each prover raises past its limit rather than run out of device memory:
T-mode and the class prover hold one class of the LDE at a time and reach
the 2^20-row linear regression (``zkvm_torch.examples.prove_lr_large``);
mono keeps the whole LDE resident, and T >= 2^18 in mono is ROADMAP A8.
Mono over a mesh of P ranks (``prove(..., mesh=...)``) holds D / P rows of
the LDE a rank, so its limit is per rank: T <= MONO_MAX_TRACE_LENGTH * P.

From ``CHUNK_T`` on, the stages of T-mode and the class prover take the
reference's chunked forms (``zkvm/prover/pipeline.py:303,339,433``,
``eval_mxu.py:97``): the trace columns' class NTTs in column blocks (trace
commit and composition), the DEEP's weighted sums one column at a time,
and the multi-point evaluation in pairs of points.  They bound the plain-torch transients of the limb
arithmetic and leave every value unchanged.  The constants are read at
each call, so tests patch them here to reach the chunked forms at small T.
"""

TMODE_MAX_TRACE_LENGTH = 1 << 20
MONO_MAX_TRACE_LENGTH = 1 << 17
CLS_MAX_TRACE_LENGTH = TMODE_MAX_TRACE_LENGTH  # the same one class at a time
CHUNK_T = 1 << 18
COLUMN_BLOCKS = 4  # the trace columns' class NTTs at T >= CHUNK_T
