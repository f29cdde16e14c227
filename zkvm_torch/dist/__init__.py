"""The distributed layer: mono's prover sharded by rows over a
``torch.distributed`` group.

Port of :mod:`zkvm.dist`.  The program is SPMD, one process a rank: rank q
owns rows [qL, (q+1)L) of every (..., 8, D) tensor, L = D / P, every rank
runs the same Fiat-Shamir transcript, and every rank returns the same
proof, whose bytes do not depend on P.

* :mod:`.mesh`: the mesh over an initialised group, row-block helpers;
* :mod:`.comm`: the collectives (the one module that calls
  ``torch.distributed``; gloo stages CUDA tensors through the host, in the
  open and counted);
* :mod:`.ntt_dist`: the four-step NTT with three all-to-all exchanges;
* :mod:`zkvm_torch.air.constraints_dist`: K4 with a halo exchange;
* :mod:`zkvm_torch.hash.merkle`: ``merkle_forest_flat`` and
  ``ShardedMerkleTree`` (subtrees on the ranks, the top on the host);
* :class:`zkvm_torch.prover.mono.ShardedMonoStages`, run by
  ``prover.prove(..., mesh=...)`` and ``vm.prove(..., config=...)``;
* :mod:`.sharded`: ``sharded_prove_step``, the reference's step;
* :mod:`.multihost`: joining a group from the environment, and
  :func:`~.multihost.spawn` for ranks on one host;
* :mod:`.run`: per-rank programs for ``spawn``, and a command line.
"""

from .mesh import Mesh, make_mesh, replicated, row_block
from .multihost import initialize, replicate_to_hosts, spawn
from .ntt_dist import coset_lde_sharded, intt_sharded, ntt_sharded

__all__ = [
    "Mesh",
    "make_mesh",
    "row_block",
    "replicated",
    "initialize",
    "replicate_to_hosts",
    "spawn",
    "ntt_sharded",
    "intt_sharded",
    "coset_lde_sharded",
]
