"""Trace-length limits of the port's provers, and the thresholds of the
chunked stage forms.

Each prover raises past its limit rather than run out of device memory.
T-mode, the class prover and mono reach the 2^20-row linear regression
(``zkvm_torch.examples.prove_lr_large``): T-mode and cls hold one class
of the LDE at a time, mono keeps the whole (28, 8, 8T) LDE resident and
runs its pointwise work in row blocks.  Mono over a mesh of P ranks
(``prove(..., mesh=...)``) holds D / P rows of the LDE a rank, and its
limit is per rank, T <= MONO_RANK_MAX_TRACE_LENGTH * P: measured at P = 2
only, and past the block every rank still holds O(T) data (the gathered
coefficients, the whole DEEP witness, FRI).

From ``CHUNK_T`` on, the stages take the reference's chunked forms
(``zkvm/prover/pipeline.py:303,339,433``, ``eval_mxu.py:97``): in T-mode
and cls the trace columns' class NTTs in column blocks (trace commit and
composition), the DEEP's weighted sums one column at a time, and the
plain (CPU) multi-point evaluation in pairs of points (on a card the
multi-eval kernel takes all points at once and holds no (Q, 8, T)
ladder); in mono the domain constants,
the composition's products and the DEEP in blocks of ``MONO_ROW_BLOCK``
rows.  They bound the int64 transients of the plain limb arithmetic and
leave every value unchanged.  Those transients exist only on the CPU now:
on a card each field op is one launch of ``csrc/field_ops.cu``, which
allocates its output alone.  There, at T = 2^18, the chunked forms peaked
at 3.89 GiB and one-piece ones at 6.25 GiB (the queries' ladders of 32
points; the DEEP 1.29 against 1.49 GiB), and at T = 2^20 T-mode's trace
commit, composition and DEEP peaked at 6.72, 6.57 and 5.44 GiB, mono's
DEEP at 16.47 (``chip_smoke.py`` phase g on an NVIDIA H100 80GB HBM3).
The blocking stays until it is measured away.  The constants are read at
each call, so tests patch them here to reach the chunked forms at small
T.
"""

TMODE_MAX_TRACE_LENGTH = 1 << 20
MONO_MAX_TRACE_LENGTH = TMODE_MAX_TRACE_LENGTH  # in one process
MONO_RANK_MAX_TRACE_LENGTH = 1 << 17  # a rank's share over a mesh: T <= this * P
CLS_MAX_TRACE_LENGTH = TMODE_MAX_TRACE_LENGTH  # the same one class at a time
CHUNK_T = 1 << 18
COLUMN_BLOCKS = 4  # the trace columns' class NTTs at T >= CHUNK_T
# Rows of mono's pointwise blocks at T >= CHUNK_T: a plain (CPU) limb
# product over (4, 8, R) holds ~8 KB of int64 transients a row, ~4 GiB at
# R = 2^19; the card's field-op kernel holds none
MONO_ROW_BLOCK = 1 << 19
