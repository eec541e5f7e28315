"""ipc_proofs_tpu_torch — the PyTorch/CUDA port of ``ipc_proofs_tpu``.

A second package beside the JAX one, with the same module paths so each
counterpart is easy to find. It imports ``torch`` and never ``jax``, and
nothing of ``ipc_proofs_tpu``: the host code it needs is copied here, the
C extensions included (``backend/native/``, built with gcc into
``_build/`` at first import; a failed build raises).
``IPC_PROOFS_NO_NATIVE=1``, read once per process, selects the pure-Python
branches instead, as in the JAX package.

- ``core``, ``store``, ``ipld``, ``state`` — the IPLD byte layer (the C
  DAG-CBOR decoder and native CID type), the blockstores, the AMT/HAMT
  trees and the Filecoin state schema.
- ``proofs`` — the range event- and storage-proof pipelines (native scan,
  match, record, witness), and the batched offline verifiers.
- ``ops`` — host packers, the blake2b-256 and keccak-256 CUDA kernels
  (``csrc/``) with their plain PyTorch versions, and the event-match masks.
- ``backend`` — ``GpuBackend``, the batch seam the drivers call, and the
  loaders of the host C extensions.
- ``witness``, ``registry``, ``serve`` — the witness wire (deltas,
  frames, aggregated claims, the chunk stream), the provenance registry,
  and the in-process proof service that micro-batches requests onto the
  card.
- ``fixtures`` — the synthetic worlds the tests and smoke run use.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
