#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipc_proofs_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--pairs N] [--messages N]
                          [--pure-pairs N] [--pure-contracts N]

Phases, none of which may fail:

1. probe — a CUDA device is required (exit 1 without one); prints the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build — the host C extensions (``backend/native/*.c``) build with gcc
   when the package is imported, raising on failure; then it compiles
   ``csrc/blake2b.cu``, ``csrc/keccak.cu`` and ``csrc/match.cu`` with nvcc
   for sm_90a (one nvcc per source, started together) and prints the build
   seconds, ptxas's register report, and the SASS instructions per pipe of
   one blake2b compression and one keccak permutation (``cuobjdump``)
   beside the algorithm's counts that the operation bounds are computed
   from;
3. kernels — each kernel's digests must equal its plain PyTorch version's
   on the card bit for bit (tolerance 0: integer hashing) and the host
   golden model (``hashlib.blake2b``, ``core.hashes.keccak256``) on a
   4,096-row sample; each kernel is timed with CUDA events over 20 warm
   launches, beside its plain version and its bound:
   - blake2b: 1,048,576 messages (BASELINE config 4's scale) from the seed,
     about a third in each size class (≤128 B, 129–256 B, 257–520 B, the
     mix of the range witness); then the multi-block kernel with one and
     with four lanes a message over the first 2,048–65,536 rows of its
     third (`BLOCKS_SWEEP`), the measurement behind its four-lane
     crossover (``ops.blake2b.QUAD_ROWS_MAX``); and so the single- and
     two-block kernels over the first 256–65,536 rows of their thirds
     (`SPLIT_SWEEP`: every multiple of the packers' 256-row tile up to
     8,704, where the paths launch them, and the rows about each
     crossover), each point equal to the kernel's digests and timed by
     warm CUDA events and device time, the measurement behind their
     crossovers (``ops.blake2b.quad_rows_max``);
   - keccak: 1,048,576 single-block messages of 0–135 B, and 262,144
     multi-block messages of 136–543 B (2–4 blocks) with rows whose block
     count is 0 (digest of zeros) or above the layout's 4 (absorbs 4);
3a. device match — the kernel leg's world at full width,
   ``synthetic_event_batch(4096, 16, 4, match_rate=0.01, seed=42)``
   (262,144 events, 16.8 MB of topic words), through the four kernels of
   ``csrc/match.cu``, counts from 0: ``match_pipeline`` on the card and
   ``sharded_match_pipeline`` on the real mesh ``make_mesh(1)`` and on a
   virtual (dp=2, sp=2) mesh over ``[cuda:0] * 4`` (six launches; a
   mesh's blocks write into its outputs with no ``torch.cat`` or
   ``torch.stack``), ``receipts_with_match`` over the flat mask (one), and the same events'
   full-word and fingerprint masks through the backend on one device and
   on the virtual mesh (one and four launches each): each bit-equal to the
   plain run on the CPU; then each kernel against its plain version on the
   card's inputs and on a CPU copy (max abs err 0, bool bytes 0 or 1) at
   full width and at the edge worlds (E = 1, 3, 33 and 300, receipts and
   rows not a multiple of a block's, an empty world, the actor filter off
   and on, receipt ids over [-2·num, 2·num) in int32 and int64); then
   ``match_pipeline`` timed by ``measure_pass_seconds`` (µs a pass,
   events/s, from replays of one CUDA graph; the kernels a call runs by
   the profiler: a mesh's calls run match_pipeline's launches and its
   count's memset, nothing else) and every kernel by CUDA
   events beside its plain version, its byte bound and, for the receipt
   reduce, one PyTorch call (``mask.view(-1, E).any(-1)``), and the
   fingerprint mask's whole call with its host copies; then the two flat
   masks (`flat_mask_study`), each launched straight through
   ``ops.build.launch``, the full-word mask beside the same mask with
   streaming loads (``csrc/match_study.cu``, built with the package's
   sources) and held equal to the plain version across the topic0 sweep:
   at 262,144, 65,536 and 2,048 rows (cold and warm CUDA events, device
   time) with the launch floor (a store-only kernel at the same grid) and
   the byte bound; both full-word masks over 0, 1, 10, 50 and 100 % of
   events whose topic0 matches, with the bound in 32-B and 64-B sectors;
   and each mask's whole call taken apart into host work, copies, launch
   and copy back; and ``match_pipeline``'s designs (`pipeline_study`:
   the package's, PR 16's, the count in one launch, a persistent grid, a
   TMA ring, two events a thread; ``csrc/match_study.cu``) held equal to
   the plain version and timed at 262,144, 65,536 and 64 events, with
   each kernel's registers, blocks an SM and waves;
3b. CID bench — ``blake2b_cid_bench_setup`` over 1,048,576 nodes of 200 B
   from the seed (BASELINE config 4; the two-block kernel): every first
   digest equal to hashlib; CIDs/s by the slope of k passes, and the kernel
   alone by CUDA events;
4. event path — ``build_range_world(4096, 16, 4, 0.01)`` (BASELINE config
   2), then ``generate_event_proofs_for_range`` with ``get_backend("gpu")``
   and ``verify_proof_bundle`` with the witness CID recompute on the card,
   through the native branches (fused C scan+match, C pass 2, C witness
   materialization, batched replay whose TxMeta recompute is a second
   single-block blake2b launch), each of which must run: every verdict
   true, one proof per matching receipt, every blake2b kernel launched, the
   TxMeta batch's digests from that launch equal to the plain versions' and
   hashlib's on the same messages; a
   second generate with ``IPC_SCAN_FUSED_MATCH=0`` must give the same bundle
   bytes and launch the fingerprint mask on the card once; each kernel is
   held against its plain version on the witness's own blocks, and the
   multi-block kernel at the witness's own multi-block rows (2,624 at
   4,096 pairs) with the wrapper's lanes (four a message there) and with
   one, each equal to hashlib and timed by CUDA events and torch.profiler
   beside its bound there, and so the single- and two-block kernels at
   their own witness rows (1,969 and 1,312) with the wrapper's lanes and
   with one and four forced, the two lane counts and the store-only floor
   at each one's launch shape (``csrc/blake2b_study.cu``) taking turns in
   one profiler session; a flipped
   byte in a witness block of each size class must be rejected; a repeat
   of the path under ``torch.profiler`` gives the card's busy time;
5. overlapped event path — the same world through
   ``generate_and_verify_range_overlapped`` (scan ∥ record ∥ merge ∥ verify
   in one bounded-queue executor) with the thread budget
   ``resolve_thread_budget()`` gives on this host (``scan_workers ×
   native_scan_threads`` must not exceed its total) and ``chunk_size =
   max(1, min(1024, pairs // max(4, 2 * scan_workers)))``, each chunk
   verified by `_staged_verify` (the witness CID recompute on the card,
   then the batched replay with the card's TxMeta recompute): the merged
   bundle's bytes must equal ``generate_event_proofs_for_range_chunked``
   at the same chunk size, every per-chunk verdict must be true and their
   concatenation equal whole-bundle verification, neither the single-core
   fallback nor a scan retry may have run, each blake2b class of the
   witness must have launched; the run's backend records every kernel
   call its worker threads make (each chunk's witness batch and TxMeta
   batch), and each recorded result must equal the plain versions (on
   the CPU) and hashlib on the same inputs, and each kernel its plain
   version at every verified chunk bundle's shapes; a repeat under
   ``torch.profiler`` gives the card's busy time; then the same run with
   ``IPC_SCAN_FUSED_MATCH=0`` must pass the same checks, give the same
   bytes and launch the fingerprint mask (its coalescing counted), each
   recorded mask equal to the plain mask on the same arrays;
5a. mesh range — the same world with the topdown nonce slot at every pair
   through ``generate_event_proofs_for_range`` with ``get_backend("gpu",
   mesh_devices=1)`` and with a virtual 4-device mesh on the card (the
   fused scan off, the fingerprint mask sharded): the single-device
   bundle's bytes; then ``generate_and_verify_range_overlapped`` over the
   virtual mesh: the same bytes, every verdict true,
   ``range_match_coalesced`` and the sharded mask's launches non-zero; every recorded mask and hash equal to the
   plain versions; then ``dryrun_multichip`` over the real cards and over
   ``[cuda:0] * 4``;
5b. multihost — a one-rank NCCL group on the card (a TCP store on
   localhost): the sharded match over ``global_mesh(sp=2)`` on
   ``[cuda:0] * 4``, the count all-reduced and the hits all-gathered
   through NCCL, equal to the single-device run;
5c. traced event path (run right after 5) — the same world through the
   overlapped driver with the span collector off and on, interleaved,
   best of 2 each (the JAX ``bench.py`` observability leg's way): the same
   bytes and the same launch counts with and without tracing, every
   recorded kernel call equal to the plain versions; the traced run's
   spans written as Chrome trace-event JSON and OTLP/JSON and POSTed to a
   collector on 127.0.0.1, each parsing back to the recorded span count;
   prints ``trace.spans_recorded``, ``trace.spans_dropped``, spans a proof
   and the overhead %;
6. storage path — BASELINE config 3: ``build_chain`` with 256 EVM
   contracts × 256 mapping slots (keys ``keccak(ascii_to_bytes32(
   f"subnet-{c}") ‖ be32(i))``, hashed on the card and sampled against
   ``core.hashes.keccak256``; values ``(i % 251).to_bytes(2, "big")``;
   direct HAMT storage, bit width 5; 50 filler actors), then
   ``generate_event_proofs_for_range`` over the one pair with the 65,536
   slots as its ``storage_specs`` (slot keccaks on the card,
   ``generate_storage_proofs_for_pairs``' batched C HAMT walks, which must
   run, one C witness materialization; the world has no events) and
   ``verify_proof_bundle`` (the batched storage verifier, which must
   run) with the CID recompute on the card: 65,536 proofs, every verdict
   true, every value the fixture's, the single-block keccak kernel and all
   three blake2b kernels launched in this phase; the keccak and blake2b
   kernels held against their plain versions at this path's shapes; a
   flipped witness byte of each size class rejected and a changed value
   given a false verdict;
7. mixed range — ``build_range_world(64, 16, 4, 0.01)`` with the topdown
   nonce slot ``MappingSlotSpec(1001, "calib-subnet-1", 0)`` proved at every
   pair through the native range branches: 64 storage proofs beside the
   event proofs, every verdict true, every proof's slot the expected keccak
   digest, a changed value given a false verdict, the range's one slot-hash
   launch and a blake2b launch for each size class of its witness counted;
   the keccak and blake2b kernels held against their plain versions at this
   path's shapes;
8. resumable mixed range — the same world and slot through
   ``generate_event_proofs_for_range_pipelined`` with a checkpoint
   directory and a job journal (temporary directories): every storage
   verdict true; a second run resumes every chunk from the journal
   (``range_chunks_resumed`` equals the chunk count), gives the same bytes,
   and launches no blake2b kernel and no mask (only the up-front slot
   keccak that the storage leg needs: the pipelined driver journals event
   chunks, not storage items); both runs' slot keccak batches and the
   verification's blake2b batches, as the kernels computed them, must
   equal the plain versions and the host golden models;
9. pure-Python paths — a child process started with
   ``IPC_PROOFS_NO_NATIVE=1`` runs the slice 1–2 branches on the card at
   reduced depth (the event path at 256 pairs; ``generate_storage_proofs_batch``
   at 16 contracts × 256 slots), each verified on the card with its own
   launch counts; their bundle digests (sha256 of the canonical JSON) must
   equal those of the native branches on the same worlds;
10. cold read — the event path's world, cut to its first 256 pairs
   (``COLD_PAIRS``), read cold: the hermetic Lotus node
   (``LocalLotusSession``) → ``LotusClient`` → ``FetchPlane`` (speculate
   depth 1, every wave verified on the card) → ``TieredBlockstore`` over a ``SegmentStore``
   in a temporary directory, through ``generate_event_proofs_for_range_pipelined``
   at the host's thread budget with ``IPC_VERIFY_MIN_BYTES=0``: the bytes
   of the in-memory path; every landed wave of two or more blocks verified
   on the card and every single-block wave on the scalar lane (the
   ``verify.*`` counters equal the waves' split); all three blake2b kernels
   and the flat event mask launched (the tier has no raw map, so the scan
   is the Python walk, as in the reference); every recorded kernel call
   equal to the plain versions and hashlib; no retry of any kind; a
   profiled repeat in a fresh directory gives the card's busy ms, and a
   third run at the default crossover (every wave on the host lane) what
   the forced lane costs;
11. warm restart — the cold run's disk reopened with the sweep at open
   (``verify_scan``) on the card at the default crossover: one verify call
   per segment over every block, no eviction, its kernel calls held against
   plain and hashlib; then the same generate through a fresh plane at
   speculate depth 0 and tier: the same bytes and not one RPC call or want;
   then again at depth 1: the same bytes, no demand want, and the RPC calls
   of the speculation that fetches links the cold run's plane dropped at
   its queue cap and no walk reads (the reference plane fetches the same);
12. lying disk — 64 frames of that disk, at seeded indices, rewritten with a
   changed block byte and a valid CRC: the sweep at open evicts exactly
   those, and a read of each through the tier refetches it (one RPC call
   each) and repairs the disk;
12a. endpoint pool — the event world's first 512 pairs (cut from 4,096
   to keep the script's time) read through an
   ``EndpointPool`` of two hermetic endpoints (the ``bench.py`` resilience
   leg's pool: breaker threshold 3, reset 50 ms, backoff 0.5–2 ms, chunks
   of 8) behind the fetch plane, every landed wave of two or more blocks
   verified by the pool on the card (``IPC_VERIFY_MIN_BYTES=0``):
   fault-free with integrity on, fault-free with integrity off (one client
   that claims to verify), and at 10 % injected faults over the first 256
   pairs (a typed abort moves to the next plan); each bundle the in-memory
   one, blake2b launched,
   every recorded lane batch equal to the plain versions and hashlib; the
   recovery ms from a dead primary to a healthy secondary; a third
   endpoint serving one flipped block (the world's first 512 pairs): it is
   demoted and the bundle does not change;
13. lying node — 4 runs at 256 pairs over ``FaultySession`` with seeded
   bit-flip plans (16 lies each): each run gives the in-memory bytes or a
   typed error (``IntegrityError``, ``RpcError``), every lie is counted
   (``rpc.integrity_failures`` + ``fetch.speculative_integrity_drops``), some
   speculative lie is dropped and some run completes (scan retries are the
   expected cost here), and a verifying reopen of each run's disk evicts
   nothing;
14. mixed-multihash sweep — one segment of 32,768 blake2b, 32,768 keccak
   (0–520 B, so both keccak kernels run), 8,192 sha2-256, 2,048 identity
   and 512 unknown-code blocks from the seed (half of each until phase 32
   came), 1 % with a flipped bit,
   swept at open on the card: each block kept exactly when
   ``verify_block_bytes`` (run in worker processes: the host keccak is pure
   Python; the keccak CIDs come from the card, so a wrong kernel fails
   here too) accepts it, the flips the only evictions, both keccak and all
   three blake2b kernels launched, the two kernel calls equal to plain and
   the host;
15. CLI — ``ipc_proofs_tpu_torch.cli.main`` as a user runs it, over
   ``build_range_world(4096, 16, 4, 0.01, chained=True)`` (the event
   path's world on 4,097 consecutive heights), cut to its first 1,024 pairs
   (``CLI_RANGE_PAIRS``, 2,048 until phase 32 came; the follower and 15c
   use the whole chain), served by the hermetic node
   (every height's tipset, the contract's f410 address and its ID), each
   run's metrics and launch counts from 0, each recorded kernel call held
   against the plain versions and hashlib:
   - ``range`` with ``--contract --storage-slot --chunk-size 512
     --checkpoint-dir --backend gpu`` at the default pipeline depth 2,
     every landed wave of two or more blocks verified on the card
     (``IPC_VERIFY_MIN_BYTES=0``): the bytes of
     ``generate_event_proofs_for_range_chunked`` in memory for the same
     pairs and specs, the three blake2b kernels, the single-block keccak
     and the flat event mask launched; a second run resumes every chunk
     with the same bytes and no ``Filecoin.ChainReadObj``;
   - ``verify --check-cids`` on that bundle: exit 0 with blake2b launched;
     with ``--f3-cert`` (a certificate over the 1,025 tipsets signed by a
     seeded power table of 4 participants with the port's ``crypto/bls.py``)
     exit 0; a certificate over other epochs exit 1; a flipped witness
     block raises in the CID recompute;
   - ``cert --power-table --verify-signatures`` over 2 consecutive
     certificates of 64 tipsets: every one validates; a forged signature
     fails; ``--emit-cbor`` writes CBOR that validates again;
   - ``generate`` (one pair: the slot keccak launched), ``vectors``
     (capture, then ``check_vectors``) and ``demo``, each exit 0;
15a. CLI ``range --mesh-devices 1`` over the first 512 pairs of the chained
   world (default crossovers): the bundle of the same command without the
   flag, the full-word mask launched sharded with the flag and flat
   without it, every recorded kernel call equal to the plain versions;
15b. chain follower — a ``ChainFollower`` (lag 1, from the chain's first
   height) over the chained world's hermetic node (which answers
   ``Filecoin.ChainHead``) warms a ``TieredBlockstore`` over a
   ``SegmentStore``, each landed wave of two or more blocks verified on the
   card, polled until the head: ``follow.errors`` 0, ``follow.tipsets``
   the heights walked, blake2b launched, every recorded lane batch equal to
   the plain versions; then the range over the chain's first 1,024 pairs
   through a fresh memory cache on the warmed disk (the in-memory bytes;
   ``prefetch_hit_ratio``); a second node
   serving one corrupt spine block: exactly one ``follow.errors``, the
   block never stored;
15c. CLI ``range --endpoints <replica> --hedge-ms 5 --breaker-threshold 3
   --trace-out F --trace-otlp G --job-dir J`` over the first 512 pairs of
   the chained world, two hermetic nodes: the bundle of the run without
   the flags; F holds the command's root, ``rpc.*``, ``pool.*``,
   pipeline-stage and ``journal.append`` spans in one trace and G as many
   spans; the pool's lane launched blake2b;
16. autotune — ``autotune_crossover(quick=False)`` on the card, its record
   written as ``verify_autotune_cuda.json``; after every phase whose fetch
   plane or disk tier verifies on the lane, since the tuned crossover
   applies to every later lane call of the process (the phases below build
   no ``store_dir`` and verify through ``verify_proof_bundle``, whose CID
   batches do not take the lane);
17. serve verify — the JAX ``bench.py`` serve leg at full size: the
   768-event chain (one contract), its full bundle (996 witness blocks,
   194,365 B) and 256 single-proof requests over it; the sequential
   baseline (`sequential_verify_baseline` on the card), then 32 closed-loop
   clients through ``ProofService`` (``max_batch=32``, ``max_wait_ms=4``,
   2 workers) with ``verify_witness_cids`` off and on: the three runs'
   verdicts equal and true; blake2b launched exactly once per merged batch
   for its TxMeta batch, plus once per size class of the merged witness
   with the CIDs on (``serve.batches.verify`` counts the merged batches);
   a request with a flipped witness byte among 31 honest ones is rejected
   in its own sub-merge and its neighbours verify; the card's digests of
   the merged witness equal the plain versions' and the CIDs; prints
   ``serve_batched_rps``, ``serve_sequential_rps``, the speedup,
   ``serve_p99_latency_ms``, ``serve_mean_batch`` and the launches;
18. serve generate — 32 closed-loop clients ask ``ProofService.generate``
   for one pair each of the 4,096-pair event world (phase 4's): each
   response's event proofs equal those of generating its pair alone, and
   every batch's claims verify over the batch's shared witness on the card
   (the window's launches); one batch of 32 pairs through a
   ``range_job_dir`` (``journal_ms`` in each response's timing, the same
   proofs); one ``submit_range_window`` with the topdown nonce slot over
   the 64-pair mixed world (the slot keccak launched; the chunked driver's
   bytes; every verdict true);
19. witness diet — the JAX ``bench.py`` witness leg on the port: the
   two-pass against the single-pass witness bytes over 64 pairs; on the
   8-pair match-dense world the wire bytes per proof at K = 1, 16 and 256
   aggregated claims, the delta ratio over 8 consecutive epochs (each
   delta rebuilt byte for byte by ``apply_delta``) and the zlib frame
   ratio (zstd too where ``zstandard`` imports; the encodings run are
   printed); ``verify_aggregated`` of the 256 claims with the witness CIDs
   on the card: one launch set (each size class once, one TxMeta batch),
   each claim's verdict that of verifying it alone;
20. registry — the JAX ``bench.py`` registry leg's in-process half: a
   ``ProofService`` with ``registry_dir`` serves 96 generate requests, each
   sealed (``encode_bundle_fields``, ``append_served`` with its CID set);
   ``registry_append_overhead_pct`` is one append (2,048 timed) over one
   served request; every record's inclusion proof verifies against the
   head, a consistency proof between two heads verifies, the head is the
   same after a reopen, and a 4-shard fleet directory resolves its
   siblings' bases through ``FleetBaseCache``;
21. http verify — phase 17's stack behind ``ProofHTTPServer`` on
   loopback (32 keep-alive client threads in a child process, so client
   and daemon do not share one GIL): the 256
   requests in process first (their verdicts), then over
   ``POST /v1/verify`` with the CIDs off and on: every answer a 200 with
   those verdicts and a ``Server-Timing`` header, blake2b one launch set a
   merged batch; one ``blocks_frame`` (zlib) request and one with a
   256-claim ``claims`` table, each one launch set and the in-process
   verdicts; prints HTTP req/s beside the in-process req/s of this run
   (one shared witness object, and one parsed a request), the body parse
   ms on one thread, ms a request and p99;
22. http generate — the event world's first 256 pairs (cut from 4,096
   to keep the script's time; 1,024 until phase 32 came) through
   ``/v1/generate``, one pair a request from 32 clients in a child
   process, against a daemon
   with a disk tier: buffered JSON (it warms the disk), then the IPBS
   stream: each answer's event proofs those of generating its pair alone,
   one flat event mask a chunk (the scan over a tier is the Python walk),
   no block byte copied on the warm stream
   (``warm_block_bytes_copied_per_resp`` 0, the JAX ``zerocopy`` leg's
   rule), ``stream_ttfb_ms``; each batch's witness verifies its claims on
   the card (one launch set a batch); one aggregated
   ``/v1/generate_range`` over repeated pair indexes equals the in-process
   service's fields;
23. http overload — the JAX ``overload`` leg's stack, uncut, with
   ``admit_gradient``: capacity at 4 clients, then 4 s at 8 with a light
   tenant and tight deadlines; every answer a 200 or a typed 429 / 504,
   generation launching nothing (the fused C scan); prints
   ``goodput_ratio_at_2x``, ``shed_rate``, ``light_tenant_p99_ms_overload``
   and ``cancel_reclaim_pct`` (recorded, not gated);
24. durable — 32 requests (16 generate, 16 verify with the CIDs on)
   admitted through ``DurableAdmission`` while the batcher holds them; the
   server aborted and the journal closed with them pending; a fresh
   service over the same directory replays all 32 (``resumed_jobs``) on
   the card, one launch set a replayed verify, each result that of a clean
   run; an ``idempotency_key`` retry over HTTP comes back ``cached``;
25. replication — daemons ``s0`` and ``s1`` with disk tiers; ``s0`` warmed
   over HTTP with the cold read's 256 pairs; ``POST /v1/replicate`` on
   ``s1``; every ingested block read back through ``get_many`` in one lane
   call on the card; one forged frame on ``s1`` repaired from ``s0``
   (``storex.replica_repairs`` 1) and a generate on ``s1`` after it reads
   nothing from its inner store;
26. cli serve — ``python -m ipc_proofs_tpu_torch.cli serve --demo-world
   256 --check-cids`` with ``--store-dir``, ``--queue-dir`` and
   ``--registry-dir`` in a child process: every pair generated, the world's
   proofs verified one a request, ``/metrics``, ``/metrics.prom``,
   ``/healthz`` read, an inclusion proof checked against the head; SIGTERM
   exits 0 with a done record for every admit; its launches are the
   daemon's own counts, which it logs at start and after the drain: their
   difference one blake2b launch set a merged verify batch
   (``serve.batches.verify``) and one event mask a generate chunk;
27. standing queries — `ProofHTTPServer` with `StandingQueries` and the SLO
   watchdog over the event world (kept alive until then), the service's
   scan unfused (the event mask on the card): 64 subscriptions over 12
   distinct filters posted over HTTP (webhooks to a receiver child process,
   one endpoint down in the first life, long-poll subscribers, 8 with a
   storage leg), delta delivery on; a `ChainFollower` over the hermetic
   node finalizes 128 tipsets (the first 64 pairs; 256 until phase 32
   came): one generation per
   distinct (pair, filter) on the PUSH lane, the storage-leg filters
   failing as the reference's do (``subs.errors``: the reference hands the
   chunked driver a pre-hashed `StorageProofSpec`), every push's digest and
   bundle bytes (a delta expanded) equal to the chunked driver's for its
   pair and filter, the long-poll cursors in order and acked by the next
   poll, every delivered bundle verified on the card, ``/healthz`` with the
   subs fields and the ``slo`` block; a restart over the same directory
   replays the registry and re-pushes every refused delivery, the same
   bytes; prints deliveries/s, generations/s and ms a tipset;
28. backfill — a `BackfillEngine` on the service's LOW lane over all 4,096
   pairs at window size 8 (the scan unfused): closed after 128 windows
   commit, resumed from the journal by a second engine (the committed
   windows replayed), the sealed bundle ``range``'s bytes and verified on
   the card; ``POST /v1/backfill`` over HTTP and ``GET
   /v1/backfill/<id>/chunks`` streamed to the end, folded with
   `BundleFold` into the same bytes (``stream_ttfb_ms``); ``python -m
   ipc_proofs_tpu_torch.cli backfill --endpoint`` over the hermetic node at
   64 pairs, every landed wave verified on the card: ``range``'s bytes;
29. cluster — `ClusterRouter` over 1, 2 and 4 in-process `LocalShard`s on
   the card over the event world (kept alive until then), the scan
   unfused: ``generate_range`` over all 4,096 pairs at chunk 1,024,
   buffered and streamed cut-through over `RouterHTTPServer`, each the
   chunked driver's bytes with exactly one fingerprint mask a chunk of
   each group the router formed; each bundle through the router's
   ``/v1/verify`` (witness CIDs on), all true, one blake2b launch set; at
   4 shards 512 single-pair generates from 8 clients (steal threshold 2);
   the JAX ``hostkill`` leg's shape (2 shards with disk tiers, R=2, every
   rolled frame of one corrupted: ``replica_repair_hit_rate``; one killed
   under a closed loop: ``kill_recovery_ms``); ``POST /v1/backfill`` over
   256 pairs through the router, folded into the driver's bytes; prints
   proofs/s by shard count and ``steal_events``;
30. cli cluster — ``python -m ipc_proofs_tpu_torch.cli cluster --shards 4
   --demo-world 64`` (4 shard processes on the one card, the kernels
   already built) with ``--store-dir`` and ``--queue-dir``, then
   ``--shards 1``: 256 ``/v1/generate`` from 8 closed-loop clients in a
   child process, each answer's proofs the driver's for its pair, then
   each pair's bundle verified through the router (all true);
   ``/healthz``, ``/v1/cluster/status`` and the fleet ``/metrics.prom``;
   SIGTERM exits 0 with every admit done; each shard's launches read from
   its log: exactly one flat mask a generate chunk and one TxMeta blake2b
   batch a merged verify batch; prints
   ``aggregate_proofs_per_sec`` and ``cluster_linearity_4shard``;
31. tools — ``ipc_proofs_tpu_torch/tools/`` driving the port on the card:
   ``chaos.run_grid`` over 256 pairs of BASELINE config 2's shape (16
   receipts, 4 events, match rate 0.01) through a fetch plane in front of
   the faulted pool, 4 seeds at fault rates 0.05 and 0.5 with
   ``IPC_VERIFY_MIN_BYTES=0`` (0 divergent, 0 untyped, 0 device-fault
   outcomes, at least one identical, blake2b launched, every recorded
   kernel call equal to the plain versions), and ``run_shard_grid`` at
   its defaults; ``crashtest.run_grid`` at 4 kill points of both
   flavours over the same 256 pairs at chunk 16 (4 points at once, so
   their children start together), beside one point each of the
   compaction, registry, backfill and SIGTERM-stream grids, children on
   the card: every point resumes byte-identical (the stream tears typed),
   every child maps the kernel libraries the parent built, and the
   resumed bundles verify on the card; ``soak --quick`` over event,
   storage, shapes, codec and range seeded from ``--seed`` (clean, keccak
   and blake2b launched, every recorded call equal to the plain versions);
   ``auditview verify / prove / diff`` over phase 20's registry log and
   ``traceview`` over phase 5c's Chrome trace exit 0, and ``verify`` of a
   copy of the log with one byte flipped exits 1; prints each tool's
   seconds, outcome counts and launches;
32. static gates — each in a child process from the checkout's root:
   ``python -m ipc_proofs_tpu_torch.tools.ipclint`` must report the port
   clean; ``build_native_san --strict``: its host half builds the C
   extensions with ASan+UBSan and ``-Werror`` (``*.san.so``) and runs the
   soak's native phases under the ASan runtime, clean; its CUDA half
   launches all nine kernel entries at edge sizes, the three blake2b
   entries with the wrapper's lanes and with one and four forced
   (block-edge lengths, multi-block rows up to the padded maximum, odd
   block counts, match worlds of E = 1, 3, 4, 5 and 33, receipt ids
   outside [0, num), 1 to 4,097 rows) between guard bands, twice with other
   fills: no redzone or input changed and every result equal to the plain
   version; then under ``compute-sanitizer`` memcheck and initcheck,
   which must report 0 errors wherever the tool supports the device (a
   refusal, "Device not supported", is printed as such); and ``pytest -m
   cuda tests/test_torch_cuda.py`` under ``IPC_LOCKDEP=1`` must pass with
   none failed or skipped and no ``LockOrderError``; prints each part's
   seconds, the files linted, the launches made in the sanitizer's
   children and the tests that ran.
33. bench — the repo's bench on the card: ``python bench_torch.py --leg
   NAME --quick`` for ``e2e`` (its card probe included), ``kernel``,
   ``cid`` and ``onchip``, each in a child under the leg's own watchdog
   (its ``--quick`` timeout): each leg's JSON says ``_platform`` ``cuda``
   and holds exactly the keys the reference leg emits (``BENCH_LEG_KEYS``,
   held against ``bench.py`` by the CPU tests), and each child's kernel
   launches (its ``bench: kernel launches`` line) include the kernels its
   leg drives; then the port's ``check_bench_schema``, in a child, passes
   the committed artifact ``bench_torch_runs/BENCH_torch_r01.json`` in
   non-current mode; prints each leg's seconds, headline number and
   launches.

After the paths: the row counts at which the paths launched the single-
and two-block kernels (each launch this process saw, in power-of-two
bins; the paths whose launches ran in child processes; and any row count
up to 65,536 that the kernel phase's sweep did not time).

Prints per-stage ms of every path with the scanner's thread count and the
CPUs it may use; then, in order before the last line: one line per kernel,
one JSON object ``{"kernels": [...]}``, the ``nvidia-smi`` name/power-limit
line; and as the last line ``{"ok": true, "device": {...}}``. Each path's
launch counts are set to 0 just before it runs and read just after. A
kernel's ``launches`` is the count on the first path that runs it (the
event path for blake2b, the storage path for the single-block keccak, the
mixed-multihash sweep for the multi-block keccak, the device match phase
for the four match kernels, whose counts add a mask's single-device and
mesh-block launches); ``launches_by_path``
holds its count on each path (the unfused event run, the overlapped runs,
the resumable range's two runs, the two pure-Python paths, the cold
read path's phases, the CLI's runs, the mesh phases, slice 8's
``traced``, ``pool``, ``follower`` and ``cli_pool``, and the serve
plane's ``serve verify`` (CIDs off), ``serve verify, cids``, ``serve
verify, sequential``, ``serve generate``, ``serve range window``,
``witness diet``, ``witness aggregate verify`` and ``registry``, and
the HTTP plane's ``http verify`` (and ``, cids``, ``, blocks_frame``,
``, claims``), ``http generate`` (and ``, stream``, ``, verify``),
``http overload``, ``durable`` (the replay), ``replication`` (the
``get_many``) and ``cli serve``, and ``subs push``, ``subs verify``,
``backfill`` (the resumed job and its verification), ``backfill stream``
and ``cli backfill``, and ``cluster`` (the buffered scatters at 1, 2 and
4 shards), ``cluster, stream``, ``cluster verify``, ``cluster load``,
``cluster hostkill``, ``cluster backfill``, ``cli cluster`` (the 4
shards' served launches, from their logs), ``cli cluster, 1 shard``,
``tools chaos``, ``tools crashtest verify``, ``tools soak``,
``static gates`` — the launches of the sanitizer's child processes — and
``bench``, the bench legs' children's launches, included). A hash
kernel's ``bound_ms`` counts the operations its algorithm needs
(`BLAKE2B_OPS`, `KECCAK_OPS`); its line also gives the bound on the
build's own SASS ("issued"). A match kernel's ``library_ms`` is the one
PyTorch call that computes the same function, where there is one.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import http.client
import http.server
import io
import itertools
import json
import multiprocessing
import os
import pickle
import random
import re
import shutil
import signal
import struct
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from ipc_proofs_tpu_torch import backend as backend_mod
from ipc_proofs_tpu_torch import cli
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.gpu import KECCAK_CLASSES, SIZE_CLASSES, GpuBackend, keccak_class, size_class
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.core.cid import (
    BLAKE2B_256,
    CID,
    DAG_CBOR,
    IDENTITY,
    KECCAK_256,
    SHA2_256,
    PurePythonCID,
)
from ipc_proofs_tpu_torch.core.hashes import keccak256
from ipc_proofs_tpu_torch.fixtures import (
    ContractFixture,
    EventFixture,
    build_chain,
    build_range_world,
    certificate_json_obj,
    finality_certificates,
    power_table_json,
    seeded_power_table,
)
from ipc_proofs_tpu_torch.entry import dryrun_multichip
from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
from ipc_proofs_tpu_torch.ops.cid_bench import blake2b_cid_bench_setup
from ipc_proofs_tpu_torch.parallel import pipeline
from ipc_proofs_tpu_torch.parallel.mesh import make_mesh
from ipc_proofs_tpu_torch.parallel.multihost import global_mesh, host_local_pairs, initialize_distributed
from ipc_proofs_tpu_torch.parallel.pipeline import (
    EventBatch,
    batch_args,
    match_pipeline,
    match_pipeline_plain,
    sharded_match_pipeline,
    synthetic_event_batch,
)
from ipc_proofs_tpu_torch.proofs.scan_native import topic_fingerprint
from ipc_proofs_tpu_torch.jobs.journal import FRAME_HEADER, read_journal
from ipc_proofs_tpu_torch.obs import (
    disable_tracing,
    enable_tracing,
    post_otlp_trace,
    write_chrome_trace,
    write_otlp_trace,
)
from ipc_proofs_tpu_torch.ops.build import KERNEL_LIBRARIES, build_libraries, cuda_tool, launch
from ipc_proofs_tpu_torch.ops.pack import (
    RATE_BYTES,
    digests_to_bytes,
    pack_single_block_blake2b,
    pack_single_block_keccak,
    pack_two_block_blake2b,
    pad_blake2b,
)
from ipc_proofs_tpu_torch.proofs import event_verifier as event_verifier_mod
from ipc_proofs_tpu_torch.proofs import range as range_mod
from ipc_proofs_tpu_torch.proofs import verifier as verifier_mod
from ipc_proofs_tpu_torch.proofs.bundle import EventProofBundle, ProofBlock, UnifiedProofBundle, bundle_obj_digest
from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof
from ipc_proofs_tpu_torch.proofs.event_generator import single_pass_witness_cids
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec, StorageProofSpec, generate_proof_bundle
from ipc_proofs_tpu_torch.proofs.range import (
    TipsetPair,
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec, generate_storage_proofs_batch
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError, autotune_crossover, load_autotune
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.vectors import check_vectors, load_vectors
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.registry import ProvenanceRegistry, verify_consistency, verify_inclusion
from ipc_proofs_tpu_torch.serve import (
    DurableAdmission,
    ProofHTTPServer,
    ProofService,
    ServiceConfig,
    sequential_verify_baseline,
)
from ipc_proofs_tpu_torch.serve.durable import QUEUE_JOURNAL_NAME
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature, left_pad_32
from ipc_proofs_tpu_torch.store import rpc as rpc_mod
from ipc_proofs_tpu_torch.store import fetchplane as fetchplane_mod
from ipc_proofs_tpu_torch.store.faults import FaultPlan, FaultySession, LocalLotusSession
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore
from ipc_proofs_tpu_torch.store import failover as failover_mod
from ipc_proofs_tpu_torch.store.failover import EndpointPool
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore
from ipc_proofs_tpu_torch.store.rpc import IntegrityError, LotusClient, RpcBlockstore, RpcError, verify_block_bytes
from ipc_proofs_tpu_torch.storex import SEGMENT_MAGIC, ChainFollower, SegmentStore, TieredBlockstore
from ipc_proofs_tpu_torch.storex import follower as follower_mod
from ipc_proofs_tpu_torch.storex import segments as segments_mod
from ipc_proofs_tpu_torch.tools import auditview as auditview_tool
from ipc_proofs_tpu_torch.tools import chaos as chaos_tool
from ipc_proofs_tpu_torch.tools import crashtest as crashtest_tool
from ipc_proofs_tpu_torch.tools import soak as soak_tool
from ipc_proofs_tpu_torch.tools import traceview as traceview_tool
from ipc_proofs_tpu_torch.tools.build_native_san import (
    BLAKE2B_BLOCK_CASES,
    BLAKE2B_SPLIT_CASES,
    FULL_SHARE_CASES,
    SLICE_CASES,
)
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget
from ipc_proofs_tpu_torch.utils.timing import measure_pass_seconds
from ipc_proofs_tpu_torch.witness import (
    WitnessBaseCache,
    WitnessOptions,
    aggregate_range_bundle,
    apply_delta,
    compress_blocks,
    decompress_blocks,
    encode_bundle_fields,
    encode_delta,
    pack_blocks,
    parse_bundle_obj,
    supported_encodings,
    verify_aggregated,
)
from ipc_proofs_tpu_torch.witness.bases import FleetBaseCache
from ipc_proofs_tpu_torch.witness.stream import decode_bundle_stream

# Peak rates of one H100 SXM at its 700 W limit. Memory: HBM3 at 3.35 TB/s
# (NVIDIA data sheet). Integer: the CUDA C++ Programming Guide's
# arithmetic-throughput table for compute capability 9.0 gives, per SM and
# clock, 64 results of 32-bit integer add, bitwise logic, shift, funnel
# shift and compare (the ALU pipe) and 64 of integer multiply-add (IMAD, the
# FMA pipe); four schedulers issue 128 thread-instructions in all. The data
# sheet's 67 TFLOP/s fp32 (128 FMA lanes x 2 flops per SM clock) gives the
# SM clocks per second.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (2 * 128)
PIPES = {  # pipe: (SASS opcodes it runs, None = every one; results per SM clock)
    "alu": (("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT"), 64),
    "fma": (("IMAD", "IMUL"), 64),
    "issue": (None, 128),
}
# What the hash algorithms need, per pipe (the bound counts these; the
# SASS counts of the build are printed beside them as "issued"). A
# 64-bit value is two 32-bit halves.
# blake2b, per compression: a G mix is 4 xors (8 LOP3), 3 rotations by
# 24, 16 and 63 (6 SHF; the rotation by 32 is a swap of halves) and 4
# three- or two-operand adds (8 IADD3, which can issue on the FMA pipe as
# IMAD). 96 G (12 rounds x 8) x 14 ALU-only + 16 LOP3 folding v into h =
# 1,360 ALU operations; plus 96 x 8 adds and the 4 xors that set the
# counter and the final flag = 2,132 issued.
# keccak-f[1600], per absorbed block: a round's theta is 20 LOP3 (five
# column parities) + 10 SHF (rotl1 of each) + 50 LOP3 (a ^ C[x-1] ^
# rotl1(C[x+1]) as one LOP3 a half), rho-pi 48 SHF, chi 50 LOP3 and iota
# 2: 180; 24 rounds + 34 absorbing xors = 4,354 ALU operations.
BLAKE2B_OPS = {"alu": 1360, "issue": 2132}
KECCAK_OPS = {"alu": 4354}

SOURCE = "ipc_proofs_tpu_torch/csrc/blake2b.cu"
KERNELS = (
    # name, TPU function it replaces, lengths (lo, hi] of its rows
    ("blake2b256_single_block", "ipc_proofs_tpu/ops/pallas_kernels.py:338", (-1, 128)),
    ("blake2b256_two_block", "ipc_proofs_tpu/ops/pallas_kernels.py:364", (128, 256)),
    ("blake2b256_blocks", "ipc_proofs_tpu/ops/blake2b_jax.py:140", (256, 520)),
)
# lanes a message in each blake2b kernel instantiation
B2B_LANES = {"SplitPlanes": 1, "PaddedBlocks": 1, "quad<SplitPlanes>": 4, "quad<PaddedBlocks>": 4}
# rows at which the kernel phase times blake2b256_blocks with one and with
# four lanes a message (its four-lane crossover)
BLOCKS_SWEEP = (2048, 4096, 8192, 8448, 8576, 10240, 16384, 32768, 65536)
# rows at which the single- and two-block kernels are timed with one and
# with four lanes a message (their four-lane crossovers): every multiple
# of the packers' 256-row tile up to 8,704 (the paths launch them at such
# multiples, mostly 256), one and two 32-message blocks of the four-lane
# kernel on each SM (4,224 and 8,448) and 128 rows more (4,352, 8,576),
# and above
SPLIT_SWEEP = tuple(sorted(set(range(256, 8705, 256)) | {4224, 8576, 10240, 12288, 16384, 32768, 65536}))
B2B_STUDY = "blake2b_study"  # built and launched by this script only, never by the package
KECCAK_SOURCE = "ipc_proofs_tpu_torch/csrc/keccak.cu"
# the path whose launches a kernel's row reports: the first path that runs it
OWN_PATH = {
    "blake2b256_single_block": "event path",
    "blake2b256_two_block": "event path",
    "blake2b256_blocks": "event path",
    "keccak256_single_block": "storage path",
    "keccak256_blocks": "mixed-multihash sweep",
    "match_pipeline": "device match pipeline",
    "event_match_mask": "device match pipeline",
    "event_match_mask_fp": "device match pipeline",
    "receipts_with_match": "device match pipeline",
}
KECCAK_KERNELS = (
    # name, TPU function it replaces, loader of its kernel instantiation
    ("keccak256_single_block", "ipc_proofs_tpu/ops/pallas_kernels.py:305", "SplitPlanes17"),
    ("keccak256_blocks", "ipc_proofs_tpu/ops/keccak_jax.py:123", "PaddedBlocks34"),
)
MATCH_SOURCE = "ipc_proofs_tpu_torch/csrc/match.cu"
MATCH_KERNELS = (
    # name (its C entry), TPU function it replaces, the LAUNCHES keys that
    # count its launches (single device, mesh blocks)
    ("match_pipeline", "ipc_proofs_tpu/parallel/pipeline.py:105", ("match_pipeline",)),
    ("event_match_mask", "ipc_proofs_tpu/ops/match_jax.py:36", ("event_match_mask", "event_match_mask_sharded")),
    ("event_match_mask_fp", "ipc_proofs_tpu/ops/match_jax.py:76",
     ("event_match_mask_fp", "event_match_mask_fp_sharded")),
    ("receipts_with_match", "ipc_proofs_tpu/ops/match_jax.py:137", ("receipts_with_match",)),
)
KECCAK_ROUNDS = 24
KECCAK_MAX_BLOCKS = 4  # the multi-block case's layout: messages of 136–543 B
SIGNATURE = "NewTopDownMessage(bytes32,uint256)"
TOPIC1 = "calib-subnet-1"
ACTOR_ID = 1001
# BASELINE config 3 (benchmarks/run_configs.py:104-158), full size
CONTRACTS = 256
SLOTS_PER_CONTRACT = 256
N_FILLER_ACTORS = 50  # build_chain's default


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` warm calls.

    A ~25 ms spin kernel goes first, so the host enqueues the timed calls
    while the card is busy and the card then runs them back to back: the
    events measure device time, not the wrapper's host overhead per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


L2_BYTES = 50 << 20  # the H100's L2 cache


def _copies(args: tuple) -> "list[tuple]":
    """``args`` and copies of its tensors, over twice the L2 in all: calls
    rotating over them read inputs that the calls between evicted. For
    inputs that fit in the L2, whose repeats on one copy would read them
    from there and not from HBM."""
    nbytes = sum(a.nbytes for a in args if isinstance(a, torch.Tensor))
    return [args] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(-(-2 * L2_BYTES // max(nbytes, 1)))
    ]


def _cold_cuda_ms(fn, copies: "list[tuple]", reps: int = 20) -> float:
    """`_cuda_ms` of ``fn`` with its inputs out of the L2: the calls rotate
    over ``copies`` (`_copies`)."""
    turn = itertools.cycle(copies)
    return _cuda_ms(lambda: fn(*next(turn)), reps=max(reps, len(copies)))


def _device_us(fn, copies: "list[tuple]", reps: int = 20) -> "dict[str, float] | None":
    """Device microseconds a call of ``fn`` spends in each CUDA kernel and
    memset it runs, by name, from torch.profiler over calls rotating over
    ``copies`` (`_copies`): the card's own time, without the launch gaps
    and host work that CUDA events around back-to-back calls include. None
    when the profiler saw no device time (then not measured)."""
    calls = max(reps, len(copies))
    turn = itertools.cycle(copies)
    for _ in range(3):
        fn(*next(turn))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*next(turn))
        torch.cuda.synchronize()
    per_call = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_call[e.key] = per_call.get(e.key, 0.0) + us / calls
    return per_call or None


def _to(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32)).to(device)


_SASS_LINE = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _sass_functions(library, key) -> "dict[str, list[tuple[int, str, str]]]":
    """The SASS of each kernel function in ``library``, keyed by
    ``key(mangled name)``: ``(address, opcode, operands)`` rows."""
    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True,
    ).stdout
    functions = {}
    for function in sass.split("Function : ")[1:]:
        loader = key(function.splitlines()[0])
        functions[loader] = [
            (int(addr, 16), op, rest) for addr, op, rest in _SASS_LINE.findall(function)
        ]
    return functions


def _loops(code) -> "list[tuple[int, int]]":
    """``(target, branch)`` address pairs of the backward branches."""
    return [
        (int(target.group(1), 16), addr)
        for addr, op, rest in code
        if op == "BRA"
        and (target := re.search(r"0x([0-9a-f]+)", rest))
        and int(target.group(1), 16) < addr
    ]


def _per_pipe(ops) -> "dict[str, int]":
    return {
        pipe: sum(opcodes is None or op.split(".")[0] in opcodes for op in ops)
        for pipe, (opcodes, _) in PIPES.items()
    }


def _loop_span(key: str, loops) -> "tuple[int, int]":
    """The address span of a kernel's one block loop: its backward
    branches (ptxas may lay a loop out with more than one) must cover one
    connected range."""
    loops = sorted(loops)
    if not loops:
        raise AssertionError(f"{key}: no block loop in the SASS")
    lo, hi = loops[0]
    for target, branch in loops[1:]:
        if target > hi:
            raise AssertionError(f"{key}: expected one block loop in the SASS, found {loops}")
        hi = max(hi, branch)
    return lo, hi


def _b2b_instantiation(mangled: str) -> str:
    """A blake2b kernel function's key: its loader, as "quad<loader>" for
    the four-lane kernel."""
    loader = next(name for name in ("SplitPlanes", "PaddedBlocks") if name in mangled)
    return f"quad<{loader}>" if "quad_kernel" in mangled else loader


def b2b_instantiation(rows: int, name: str = "blake2b256_blocks") -> str:
    """The instantiation the blake2b kernel ``name`` runs at ``rows`` rows."""
    loader = "PaddedBlocks" if name == "blake2b256_blocks" else "SplitPlanes"
    return f"quad<{loader}>" if blake2b.lanes_for_rows(rows, name) == 4 else loader


def sass_per_compression(library) -> "dict[str, dict[str, int]]":
    """Thread-instructions per pipe in one compression of each blake2b
    kernel instantiation, counted in the SASS of this build: the body of
    the kernel's block loop (one compression a trip, ``#pragma unroll 1``),
    from the target of its one backward branch to that branch, times the
    lanes that share a message (`B2B_LANES`). The per-row code outside the
    loop is left out, so the bound stays a lower one."""
    counts = {}
    for key, code in _sass_functions(library, _b2b_instantiation).items():
        lo, hi = _loop_span(key, _loops(code))
        body = [op for addr, op, _ in code if lo <= addr <= hi]
        counts[key] = {pipe: n * B2B_LANES[key] for pipe, n in _per_pipe(body).items()}
        counts[key]["shfl"] = sum(op.startswith("SHFL") for op in body) * B2B_LANES[key]
    return counts


def sass_per_permutation(library) -> "dict[str, dict[str, int]]":
    """Instructions per pipe in one absorbed keccak block (one
    keccak-f[1600] permutation) of each kernel instantiation, counted in the
    SASS of this build. The kernel has two loops: the round loop inside the
    block loop. A block costs 24 times the round loop's body (one round; the
    body loads one round constant from ``c[0x3]``, a body unrolled k times
    loads k and counts 24 / k times) plus the rest of the block loop's body
    (the loads and the absorbing xors). The per-row code outside the block
    loop is left out, so the bound stays a lower one."""
    counts = {}
    loaders = [k[2] for k in KECCAK_KERNELS]
    for loader, code in _sass_functions(library, lambda h: next(n for n in loaders if n in h)).items():
        loops = sorted(_loops(code), key=lambda loop: loop[1] - loop[0])
        if len(loops) != 2 or not loops[1][0] <= loops[0][0] < loops[0][1] <= loops[1][1]:
            raise AssertionError(f"{loader}: expected a round loop inside a block loop, found {loops}")
        (r_lo, r_hi), (b_lo, b_hi) = loops
        rounds = [(op, rest) for addr, op, rest in code if r_lo <= addr <= r_hi]
        absorb = [op for addr, op, _ in code if b_lo <= addr <= b_hi and not r_lo <= addr <= r_hi]
        unrolled = sum("c[0x3]" in rest for _, rest in rounds)
        if unrolled < 1 or KECCAK_ROUNDS % unrolled:
            raise AssertionError(f"{loader}: {unrolled} round-constant loads in the round loop")
        per_body = _per_pipe([op for op, _ in rounds])
        per_block = _per_pipe(absorb)
        counts[loader] = {
            pipe: KECCAK_ROUNDS // unrolled * per_body[pipe] + per_block[pipe] for pipe in PIPES
        }
    return counts


def _ops_ms(per_unit: "dict[str, int]", units: int) -> float:
    """The busiest pipe's time for ``units`` compressions or permutations
    (``per_unit``: operations a unit on some of `PIPES`)."""
    return 1e3 * units * max(
        count / (PIPES[pipe][1] * SM_CLOCKS_PER_S) for pipe, count in per_unit.items() if pipe in PIPES
    )


@dataclasses.dataclass
class KernelCase:
    """One kernel's inputs on the card, plus what its bound is made of."""

    name: str
    loader: str
    args: tuple
    plain: object
    golden: list  # a host golden-model sample: (row, expected digest bytes)
    bytes_moved: int
    units: int  # blake2b compressions or keccak permutations the data needs


def _blake2b(message: bytes) -> bytes:
    return hashlib.blake2b(message, digest_size=32).digest()


def _kernel_cases(n_messages: int, seed: int, device) -> "list[KernelCase]":
    """``n_messages`` random messages split into thirds by size class, each
    third laid out as its blake2b kernel takes it."""
    rng = np.random.default_rng(seed)
    cases = []
    sizes = (n_messages // 3, n_messages // 3, n_messages - 2 * (n_messages // 3))
    for (name, _, (lo, hi)), rows in zip(KERNELS, sizes):
        if not size_class(lo + 1) == size_class(hi) == name:
            raise AssertionError(f"lengths {lo + 1}..{hi} do not route to {name}")
        cap = max(128, -(-hi // 128) * 128)
        lengths = rng.integers(lo + 1, hi + 1, size=rows).astype(np.int32)
        raw = rng.integers(0, 256, size=(rows, cap), dtype=np.uint8)
        raw[np.arange(cap)[None, :] >= lengths[:, None]] = 0
        sample = rng.choice(rows, size=min(4096, rows), replace=False)
        golden = [(int(i), _blake2b(raw[i, : lengths[i]].tobytes())) for i in sample]
        n_blocks = np.maximum(-(-lengths // 128), 1).astype(np.int32)
        if name == "blake2b256_blocks":
            blocks = raw.reshape(rows, cap // 128, 128).view(np.uint32)
            args = (_to(blocks, device), _to(n_blocks, device), _to(lengths, device))
            plain = blake2b.blake2b256_blocks_plain
            bytes_moved = int(n_blocks.sum()) * 128 + rows * (4 + 4 + 32)
        else:
            words = raw.view(np.uint32)
            args = (
                _to(words[:, 0::2], device),
                _to(words[:, 1::2], device),
                _to(lengths[:, None], device),
            )
            plain = getattr(blake2b, name + "_plain")
            bytes_moved = rows * (cap + 4 + 32)
        loader = b2b_instantiation(rows, name)
        cases.append(KernelCase(name, loader, args, plain, golden, bytes_moved, int(n_blocks.sum())))
    return cases


def _keccak_padded(rng, rows: int, lo: int, hi: int, max_blocks: int):
    """``rows`` random messages of lo..hi bytes, keccak-padded in place
    (``0x01`` after the message, ``0x80`` on the last byte of its last rate
    block) in ``[rows, max_blocks * 136]`` bytes; returns (raw, lengths,
    block counts)."""
    cap = max_blocks * RATE_BYTES
    lengths = rng.integers(lo, hi + 1, size=rows)
    raw = rng.integers(0, 256, size=(rows, cap), dtype=np.uint8)
    raw[np.arange(cap)[None, :] >= lengths[:, None]] = 0
    n_blocks = (lengths // RATE_BYTES + 1).astype(np.int32)
    every = np.arange(rows)
    raw[every, lengths] ^= 0x01
    raw[every, n_blocks * RATE_BYTES - 1] ^= 0x80
    return raw, lengths, n_blocks


def _keccak_cases(n_single: int, n_multi: int, seed: int, device) -> "list[KernelCase]":
    """``n_single`` messages of 0–135 B for the single-block kernel and
    ``n_multi`` of 136–543 B for the multi-block one, laid out as each
    takes them. Two multi-block rows get a block count of 0 (the digest
    stays zero) and two 4-block rows one above the layout's 4 (they absorb
    4 blocks, so their digest is still the message's)."""
    rng = np.random.default_rng(seed + 1)
    cases = []
    for (name, _, loader), (rows, lo, hi, max_blocks) in zip(
        KECCAK_KERNELS,
        ((n_single, 0, RATE_BYTES - 1, 1), (n_multi, RATE_BYTES, 4 * RATE_BYTES - 1, KECCAK_MAX_BLOCKS)),
    ):
        if not keccak_class(lo) == keccak_class(hi) == name:
            raise AssertionError(f"lengths {lo}..{hi} do not route to {name}")
        raw, lengths, n_blocks = _keccak_padded(rng, rows, lo, hi, max_blocks)
        sample = rng.choice(rows, size=min(4096, rows), replace=False)
        messages = {int(i): raw[i, : lengths[i]].tobytes() for i in sample}
        if name == "keccak256_blocks":
            empty = [int(i) for i in sample[:2]]
            over = [int(i) for i in sample[2:] if n_blocks[i] == max_blocks][:2]
            n_blocks[empty] = 0
            n_blocks[over] = max_blocks + 3
            golden = [(i, bytes(32) if i in empty else keccak256(m)) for i, m in messages.items()]
            blocks = raw.reshape(rows, max_blocks, RATE_BYTES).view(np.uint32)
            args = (_to(blocks, device), _to(n_blocks, device))
            used = int(np.clip(n_blocks, 0, max_blocks).sum())
            bytes_moved = used * RATE_BYTES + rows * (4 + 32)
        else:
            golden = [(i, keccak256(m)) for i, m in messages.items()]
            words = raw.view(np.uint32)
            args = (_to(words[:, 0::2], device), _to(words[:, 1::2], device))
            used = rows
            bytes_moved = rows * (RATE_BYTES + 32)
        plain = getattr(keccak, name + "_plain")
        cases.append(KernelCase(name, loader, args, plain, golden, bytes_moved, used))
    return cases


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def kernel_phase(
    cases: "list[KernelCase]", module, ops: "dict[str, int]", issued: "dict[str, dict[str, int]]"
) -> "dict[str, dict]":
    """Each case's kernel (``module.<name>``) against its plain version on
    the card and against the host golden sample, then its time, its plain
    version's and its bound: the larger of its bytes over HBM and the
    algorithm's operations ``ops`` a unit over the busiest pipe; the same
    over the build's own SASS counts (``issued``, per loader) is kept
    beside it."""
    results = {}
    for case in cases:
        kernel = getattr(module, case.name)
        out = kernel(*case.args)
        ref = case.plain(*case.args)
        torch.cuda.synchronize()
        err = _max_abs_err(out, ref)
        if err != 0:
            raise AssertionError(f"{case.name}: kernel differs from its plain version")
        words = out.cpu().numpy().view(np.uint32)
        for row, digest in case.golden:
            if words[row].astype("<u4").tobytes() != digest:
                raise AssertionError(f"{case.name}: row {row} differs from the host golden model")
        ms = _cuda_ms(lambda: kernel(*case.args), reps=20)
        plain_ms = _cuda_ms(lambda: case.plain(*case.args), reps=3, warmup=1)
        bytes_ms = case.bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = _ops_ms(ops, case.units)
        results[case.name] = {
            "rows": case.args[0].shape[0],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "issued_bound_ms": max(bytes_ms, _ops_ms(issued[case.loader], case.units)),
        }
        _log(
            f"kernel {case.name}: rows={results[case.name]['rows']} equal to plain "
            f"and to the host golden model on {len(case.golden)} rows"
        )
    return results


def _classes(blocks) -> "dict[str, list[int]]":
    """Witness block positions per size class."""
    out: "dict[str, list[int]]" = {name: [] for name in SIZE_CLASSES}
    for i, block in enumerate(blocks):
        out[size_class(len(block.data))].append(i)
    return out


def _check_witness_shapes(blocks, device) -> "list[str]":
    """Each kernel against its plain version on the witness's own blocks,
    packed as the backend packs them; returns the kernels the witness has
    blocks for."""
    by_class = {k: [blocks[i].data for i in v] for k, v in _classes(blocks).items()}
    present = [name for name, data in by_class.items() if data]
    for name in present:
        if name == "blake2b256_blocks":
            packed, n_blocks, lengths = pad_blake2b(by_class[name])
            args = (_to(packed, device), _to(n_blocks, device), _to(lengths, device))
        else:
            packer = {
                "blake2b256_single_block": pack_single_block_blake2b,
                "blake2b256_two_block": pack_two_block_blake2b,
            }[name]
            m_lo, m_hi, lengths, _ = packer(by_class[name])
            args = (_to(m_lo, device), _to(m_hi, device), _to(lengths, device))
        if not torch.equal(getattr(blake2b, name)(*args), getattr(blake2b, name + "_plain")(*args)):
            raise AssertionError(f"{name}: kernel differs from plain at the witness shape")
    return present


def _check_slot_keccak(preimages, device) -> None:
    """The single-block keccak kernel against its plain version on a path's
    own slot preimages, packed as the backend packs them."""
    lo, hi, _ = pack_single_block_keccak(preimages)
    args = (_to(lo, device), _to(hi, device))
    if not torch.equal(keccak.keccak256_single_block(*args), keccak.keccak256_single_block_plain(*args)):
        raise AssertionError("keccak256_single_block: kernel differs from plain at the path's shape")


def _reject_changed_value(bundle) -> None:
    """A storage proof whose value was changed must get a false verdict."""
    proof = bundle.storage_proofs[1 % len(bundle.storage_proofs)]
    value = "0x" + "00" * 31 + ("fe" if proof.value.endswith("ff") else "ff")
    verdict = verify_proof_bundle(
        UnifiedProofBundle(
            storage_proofs=[dataclasses.replace(proof, value=value)],
            event_proofs=[],
            blocks=bundle.blocks,
        ),
        TrustPolicy.accept_all(),
    ).storage_results
    if verdict != [False]:
        raise AssertionError(f"a changed storage value was given the verdict {verdict}")


# the row count of each blake2b launch in this process since the last
# `_reset_counts`, by kernel (`record_launch_rows`), and beside each
# launch-count dict `_counts` returned, the rows of its launches
_launch_rows: "dict[str, collections.Counter[int]]" = {}
_rows_behind: "list[tuple[dict, dict]]" = []
_rows_lock = threading.Lock()


def record_launch_rows() -> None:
    """Have every blake2b wrapper's launch in this process record its row
    count (`launch_rows_by_path`); the launch itself is unchanged."""
    inner = blake2b._launch

    def spy(name, args, n, device):
        out = inner(name, args, n, device)
        if n:
            with _rows_lock:
                _launch_rows.setdefault(name, collections.Counter())[n] += 1
        return out

    blake2b._launch = spy


def _reset_counts() -> None:
    blake2b.reset_launch_counts()
    keccak.reset_launch_counts()
    match.reset_launch_counts()
    pipeline.reset_launch_counts()
    with _rows_lock:
        _launch_rows.clear()


def _counts() -> "dict[str, int]":
    counts = dict(blake2b.LAUNCHES, **keccak.LAUNCHES, **match.LAUNCHES, **pipeline.LAUNCHES)
    with _rows_lock:
        _rows_behind.append((counts, {name: collections.Counter(c) for name, c in _launch_rows.items()}))
    return counts


def launch_rows_by_path(launch_counts: "dict[str, dict]", names) -> dict:
    """For each blake2b kernel of ``names``, the row counts of its launches
    over all paths (``launch_counts``: path label -> its launch counts):
    the launches counted, those whose rows this process recorded (a
    path's counts that `_counts` returned, its recorded rows adding up to
    them), the paths whose launches it did not see (launched in child
    processes, or counts put together otherwise), and the recorded rows
    exactly and in power-of-two bins [2^k, 2^(k+1))."""
    out = {}
    for name in names:
        rows: "collections.Counter[int]" = collections.Counter()
        recorded, unseen = 0, {}
        for label, counts in launch_counts.items():
            k = counts.get(name, 0)
            seen = next((r.get(name, collections.Counter()) for c, r in _rows_behind if c is counts), None)
            if seen is not None and sum(seen.values()) == k:
                rows.update(seen)
                recorded += k
            elif k:
                unseen[label] = k
        bins: "collections.Counter[str]" = collections.Counter()
        for n, k in sorted(rows.items()):
            low = 1 << (n.bit_length() - 1)
            bins[f"{low}-{2 * low - 1}"] += k
        out[name] = {"launches": recorded + sum(unseen.values()), "recorded": recorded, "unseen": unseen,
                     "bins": dict(bins), "rows": {str(n): k for n, k in sorted(rows.items())}}
    return out


def _require_launched(path: str, launches: "dict[str, int]", names) -> None:
    idle = [name for name in names if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path} did not launch: {idle}")


def _require_blake2b(path: str, launches: "dict[str, int]") -> None:
    """At least one blake2b kernel launched (which size classes a path's
    waves hold depends on the wave's blocks)."""
    if not sum(launches[name] for name in SIZE_CLASSES):
        raise AssertionError(f"{path} launched no blake2b kernel: {launches}")


def _reject_flipped_blocks(bundle, backend) -> None:
    """A flipped byte in one witness block of each size class must make the
    CID recompute raise ValueError (the tampered bundle keeps at most one
    storage proof, so a missed rejection fails fast)."""
    for name, positions in _classes(bundle.blocks).items():
        if not positions:
            raise AssertionError(f"the witness has no block in the class of {name}")
        index = positions[len(positions) // 2]
        block = bundle.blocks[index]
        flipped = bytearray(block.data)
        flipped[len(flipped) // 2] ^= 0x01
        tampered = UnifiedProofBundle(
            storage_proofs=bundle.storage_proofs[:1],
            event_proofs=bundle.event_proofs,
            blocks=bundle.blocks[:index] + [ProofBlock(block.cid, bytes(flipped))] + bundle.blocks[index + 1 :],
        )
        try:
            verify_proof_bundle(
                tampered, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
            )
        except ValueError:
            continue
        raise AssertionError(f"a flipped byte in a {len(block.data)}-byte block was accepted")


def _verify_cids_s(bundle, backend) -> float:
    """Seconds of the witness CID recompute alone (outside a counted window)."""
    chain = [b for b in bundle.blocks if b.cid.mh_code == BLAKE2B_256]
    t0 = time.perf_counter()
    if not backend.verify_block_cids([b.cid.digest for b in chain], [b.data for b in chain]):
        raise AssertionError("witness CID recompute failed on an untampered bundle")
    return time.perf_counter() - t0


# The native branches of the paths: each entry point is wrapped while a path
# runs, and the path fails unless every one it needs ran and returned its
# native result (not the pure-Python fallback's None / False).
NATIVE_ENTRIES = (
    (range_mod, "_scan_and_match", lambda out: out[1]),
    (range_mod, "_record_pass2_native", lambda out: out is not None),
    (range_mod, "generate_storage_proofs_for_pairs", lambda out: out is not None),
    (event_verifier_mod, "reconstruct_execution_orders_batch", lambda out: out is not None),
    (event_verifier_mod, "scan_events_flat", lambda out: out is not None),
    (verifier_mod, "verify_storage_proofs_batch", lambda out: out is not None),
)
EVENT_BRANCHES = (
    "_scan_and_match",
    "_record_pass2_native",
    "reconstruct_execution_orders_batch",
    "scan_events_flat",
)


@contextlib.contextmanager
def _native_branches(path: str, expected):
    """Fail ``path`` unless each entry named in ``expected`` ran in the block
    and every call of it took the native branch."""
    seen: "dict[str, list[bool]]" = {}
    originals = []

    def spy(fn, name, ok):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, []).append(bool(ok(out)))
            return out

        return wrapper

    for module, name, ok in NATIVE_ENTRIES:
        originals.append((module, name, getattr(module, name)))
        setattr(module, name, spy(getattr(module, name), name, ok))
    try:
        yield seen
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    missed = [name for name in expected if not seen.get(name) or not all(seen[name])]
    if missed:
        raise AssertionError(f"{path}: the native branch did not run for {missed} ({seen})")
    _log(f"{path}: native branches ran: " + ", ".join(f"{k} x{len(v)}" for k, v in sorted(seen.items())))


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def _host_info() -> str:
    return f"scan_threads={load_scan_ext().scan_threads()} cpus={len(os.sched_getaffinity(0))}"


class _RecordingBackend:
    """The card's backend, recording every kernel call a path makes with
    what the kernels returned, from any number of host threads: each
    direct ``blake2b256_batch`` call (the verifier's TxMeta recompute) in
    ``batches``, each ``verify_block_cids`` batch (the witness recompute)
    in ``cid_batches``, each ``keccak256_batch`` call and each fingerprint
    mask with its inputs. `_check_recorded` holds them against the plain
    versions afterwards."""

    def __init__(self, backend):
        self._backend = backend
        self._lock = threading.Lock()
        self.batches: "list[tuple[list[bytes], list[bytes]]]" = []
        self.cid_batches: "list[tuple[list[bytes], list[bytes]]]" = []
        self.keccak_batches: "list[tuple[list[bytes], list[bytes]]]" = []
        self.masks: "list[tuple[tuple, np.ndarray]]" = []
        self.event_masks: "list[tuple[tuple, list]]" = []

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def _record(self, into: list, entry) -> None:
        with self._lock:
            into.append(entry)

    def blake2b256_batch(self, messages):
        digests = self._backend.blake2b256_batch(messages)
        self._record(self.batches, (list(messages), list(digests)))
        return digests

    def verify_block_cids(self, cids_digests, blocks):
        digests = self._backend.blake2b256_batch(blocks)
        self._record(self.cid_batches, (list(blocks), list(digests)))
        return len(digests) == len(cids_digests) and all(d == e for d, e in zip(digests, cids_digests))

    def keccak256_batch(self, messages):
        digests = self._backend.keccak256_batch(messages)
        self._record(self.keccak_batches, (list(messages), list(digests)))
        return digests

    def event_match_mask_fp(self, *args):
        mask = self._backend.event_match_mask_fp(*args)
        self._record(self.masks, (args, np.array(mask, copy=True)))
        return mask

    def event_match_mask(self, events, *args):
        mask = self._backend.event_match_mask(events, *args)
        self._record(self.event_masks, ((list(events), *args), list(mask)))
        return mask


def _check_recorded(label: str, recording: _RecordingBackend, plain_cache: dict) -> dict:
    """Every kernel result a path's run recorded, at the shapes the path
    gave the kernels, against the plain PyTorch versions on the same inputs
    (on the CPU, tolerance 0) and the host golden models (hashlib,
    ``core.hashes.keccak256``); each fingerprint mask against the plain
    mask on the same arrays. ``plain_cache`` keeps plain digests across
    runs of one world. Returns the batch and row counts it checked."""
    cpu = get_backend("gpu", device="cpu")
    checked = {}
    for kind, batches, plain, golden in (
        ("blake2b", recording.batches + recording.cid_batches, cpu.blake2b256_batch, _blake2b),
        ("keccak", recording.keccak_batches, cpu.keccak256_batch, keccak256),
    ):
        cache = plain_cache.setdefault(kind, {})
        todo = list({m for messages, _ in batches for m in messages if m not in cache})
        cache.update(zip(todo, plain(todo)))
        for messages, digests in batches:
            if digests != [cache[m] for m in messages]:
                raise AssertionError(f"{label}: a {kind} batch differs from the plain versions")
            if digests != [golden(m) for m in messages]:
                raise AssertionError(f"{label}: a {kind} batch differs from the host golden model")
        checked[kind] = {"batches": len(batches), "rows": sum(len(m) for m, _ in batches)}
    for args, mask in recording.masks:
        # a mesh backend's mask has the padded length: its first N rows
        # count, and its filler rows must all be False
        n = len(args[0])
        if not np.array_equal(mask[:n], cpu.event_match_mask_fp(*args)):
            raise AssertionError(f"{label}: a fingerprint mask differs from the plain mask")
        if np.asarray(mask[n:]).any():
            raise AssertionError(f"{label}: a filler row of a padded fingerprint mask matched")
    checked["event_match_mask_fp"] = {"calls": len(recording.masks), "rows": sum(len(a[0]) for a, _ in recording.masks)}
    for args, mask in recording.event_masks:
        if mask != cpu.event_match_mask(*args):
            raise AssertionError(f"{label}: a flat event mask differs from the plain mask")
    checked["event_match_mask"] = {
        "calls": len(recording.event_masks), "rows": sum(len(a[0]) for a, _ in recording.event_masks)
    }
    return checked


def _check_txmeta_batch(recording: _RecordingBackend) -> int:
    """The event path's one TxMeta batch, as the card computed it during the
    path, against the plain PyTorch versions on the same messages and
    against the host golden model: on an honest bundle the batch must be
    clean. Returns its row count."""
    if len(recording.batches) != 1:
        raise AssertionError(f"event path: {len(recording.batches)} TxMeta batches, expected 1")
    [(messages, digests)] = recording.batches
    if not messages:
        raise AssertionError("event path: the TxMeta batch is empty")
    if digests != get_backend("gpu", device="cpu").blake2b256_batch(messages):
        raise AssertionError("event path: the TxMeta batch differs from the plain versions")
    if digests != [_blake2b(m) for m in messages]:
        raise AssertionError("event path: the TxMeta batch differs from hashlib")
    return len(messages)


def _generate_and_verify(generate, backend):
    """One path's run, counts from 0: ``generate(metrics)`` then the
    verifier with the CID recompute on the card. The garbage of the world's
    set-up is collected first, outside the timed window. Returns (bundle,
    result, metrics, stage ms, launches)."""
    gc.collect()
    metrics = Metrics()
    _reset_counts()
    t0 = time.perf_counter()
    bundle = generate(metrics)
    t1 = time.perf_counter()
    result = verify_proof_bundle(
        bundle, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stages = {k: v * 1e3 for k, v in metrics.stage_s.items()}
    stages.update(generate_total=(t1 - t0) * 1e3, verify_total=(t2 - t1) * 1e3)
    return bundle, result, metrics, stages, _counts()


def _event_generate(store, pairs, backend):
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    return lambda metrics: generate_event_proofs_for_range(
        store, pairs, spec, match_backend=backend, metrics=metrics
    )


def _profiled(run):
    """``run()`` under torch.profiler: its result, and the device ms of the
    CUDA kernels it launched (None when the profiler saw no CUDA kernel:
    then not measured)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        out = run()
    busy_us = sum(
        getattr(e, "self_device_time_total", 0) or 0
        for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    )
    return out, (busy_us / 1e3 if busy_us > 0 else None)


def _device_busy(generate, backend) -> dict:
    """A repeat of a path's run (`_generate_and_verify`) under
    torch.profiler: its stage ms and the card's busy ms."""
    (_, _, _, stages, _), busy_ms = _profiled(lambda: _generate_and_verify(generate, backend))
    return {"stage_ms": stages, "busy_ms": busy_ms}


def event_world(n_pairs: int):
    """BASELINE config 2's world: ``build_range_world(n_pairs, 16, 4, 0.01)``."""
    t0 = time.perf_counter()
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    _log(
        f"world: {n_pairs} pairs, {len(store)} blocks, {n_matching} matching receipts, "
        f"{time.perf_counter() - t0:.1f} s"
    )
    return store, pairs, n_matching


def event_path(world, device) -> dict:
    """BASELINE config 2: the 4096-pair event-proof range (``world``, from
    `event_world`) through the native branches (fused C scan+match, C pass
    2, C witness materialization, batched replay with the TxMeta recompute
    on the card)."""
    store, pairs, n_matching = world
    n_pairs = len(pairs)
    backend = get_backend("gpu")
    recording = _RecordingBackend(backend)

    with _native_branches("event path", EVENT_BRANCHES):
        bundle, result, metrics, stages, launches = _generate_and_verify(
            _event_generate(store, pairs, backend), recording
        )
    wall_ms = stages["generate_total"] + stages["verify_total"]
    if len(result.event_results) != n_matching or not all(result.event_results):
        raise AssertionError("event path: a verdict is false")
    if len(bundle.event_proofs) != n_matching:
        raise AssertionError(
            f"event path: {len(bundle.event_proofs)} proofs for {n_matching} matching receipts"
        )
    _require_launched("event path", launches, SIZE_CLASSES)
    # the witness recompute and the batched TxMeta recompute each launch it
    if launches["blake2b256_single_block"] < 2:
        raise AssertionError(f"event path: no TxMeta recompute launch ({launches})")
    txmeta_rows = _check_txmeta_batch(recording)
    _log(f"event path: TxMeta batch of {txmeta_rows} rows equal to plain and to hashlib")

    # the unfused branch: flat arrays, the fingerprint mask on the card
    unfused_metrics = Metrics()
    with _env("IPC_SCAN_FUSED_MATCH", "0"):
        _reset_counts()
        t1 = time.perf_counter()
        unfused = _event_generate(store, pairs, backend)(unfused_metrics)
        unfused_ms = (time.perf_counter() - t1) * 1e3
        unfused_launches = _counts()
    if unfused.to_json() != bundle.to_json():
        raise AssertionError("event path: the unfused bundle differs from the fused one")
    if unfused_launches["event_match_mask_fp"] != 1:
        raise AssertionError(f"event path: unfused mask launches {unfused_launches}")

    verify_cids_s = _verify_cids_s(bundle, backend)
    _check_witness_shapes(bundle.blocks, device)
    multi_block = witness_multi_block(bundle.blocks, device)
    small_blocks = witness_small_blocks(bundle.blocks, device)
    _reject_flipped_blocks(bundle, backend)
    profiled = _device_busy(_event_generate(store, pairs, backend), backend)
    return {
        "pairs": n_pairs,
        "proofs": len(bundle.event_proofs),
        "events": metrics.counters.get("range_events", 0),
        "witness_blocks": {name: len(v) for name, v in _classes(bundle.blocks).items()},
        "witness_multi_block": multi_block,
        "witness_small_blocks": small_blocks,
        "txmeta_rows": txmeta_rows,
        "stage_ms": dict(stages, verify_cids=verify_cids_s * 1e3),
        "unfused": {
            "generate_total_ms": unfused_ms,
            "stage_ms": {k: v * 1e3 for k, v in unfused_metrics.stage_s.items()},
            "launches": unfused_launches,
        },
        "proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
        "profiled_run": profiled,
        "launches": launches,
        "host": _host_info(),
    }


def witness_multi_block(blocks, device) -> dict:
    """`blake2b256_blocks` at the event path's own multi-block witness rows,
    packed as the backend packs them: with the lanes the wrapper picks
    there and with one lane a message (PR 16's design), each equal to its
    plain version and to hashlib on every row, then timed by CUDA events
    over 20 back-to-back calls (warm: the rows, 1.4 MB at 4,096 pairs, sit
    in the L2 as they do right after the backend's copy) and by its device
    time from torch.profiler."""
    data = [blocks[i].data for i in _classes(blocks)["blake2b256_blocks"]]
    packed, n_blocks, lengths = pad_blake2b(data)
    args = (_to(packed, device), _to(n_blocks, device), _to(lengths, device))
    want = blake2b.blake2b256_blocks_plain(*args)
    rows = len(data)
    out = {
        "rows": rows,
        "compressions": {int(c): int((n_blocks == c).sum()) for c in np.unique(n_blocks)},
        "units": int(n_blocks.sum()),
        "bytes": int(n_blocks.sum()) * 128 + rows * (4 + 4 + 32),
        "instantiation": b2b_instantiation(rows),
    }
    for key, lanes in (("", None), ("one_lane_", 1)):
        def call(*_, lanes=lanes):
            return blake2b.blake2b256_blocks_on_lanes(*args, lanes)

        got = call()
        err = _max_abs_err(got, want)
        torch.cuda.synchronize()
        if err or digests_to_bytes(got.cpu().numpy()) != [_blake2b(m) for m in data]:
            raise AssertionError(f"blake2b256_blocks (lanes {lanes}) differs from plain or hashlib at the witness rows")
        device_us = _device_us(call, [()])
        out[key + "max_abs_err"] = err
        out[key + "ms"] = _cuda_ms(call, reps=20)
        out[key + "device_ms"] = sum(device_us.values()) / 1e3 if device_us else None
    return out


def witness_small_blocks(blocks, device) -> dict:
    """`blake2b256_single_block` and `blake2b256_two_block` at the event
    path's own witness rows of their size classes, packed as the backend
    packs them (rows padded to a multiple of 256): with the lanes the
    wrapper picks there and with one and four lanes forced, each equal to
    its plain version and to hashlib on every row; then each lane count
    timed by CUDA events over 20 back-to-back calls (warm, as
    `witness_multi_block` times the multi-block kernel) and by its device
    time, the two lane counts and the store-only floor at each one's
    launch shape (`b2b_floor`) taking turns in one torch.profiler session,
    each over its own copy of the inputs (`_split_lanes_us`); the keys
    without a lane prefix are the wrapper's pick. With what the bound is
    made of: the real rows' bytes and compressions."""
    out = {}
    for name, pack_rows, cap in (("blake2b256_single_block", pack_single_block_blake2b, 128),
                                 ("blake2b256_two_block", pack_two_block_blake2b, 256)):
        data = [blocks[i].data for i in _classes(blocks)[name]]
        m_lo, m_hi, lengths, rows = pack_rows(data)
        args = (_to(m_lo, device), _to(m_hi, device), _to(lengths, device))
        want = getattr(blake2b, name + "_plain")(*args)
        golden = [_blake2b(m) for m in data]
        on_lanes = getattr(blake2b, name + "_on_lanes")
        sent = int(m_lo.shape[0])
        row = {"rows": rows, "padded_rows": sent, "lanes": blake2b.lanes_for_rows(sent, name),
               "units": sum(max(-(-len(m) // 128), 1) for m in data), "bytes": rows * (cap + 4 + 32)}
        for key, lanes in (("", None), ("one_lane_", 1), ("four_lanes_", 4)):
            got = on_lanes(*args, lanes)
            err = _max_abs_err(got, want)
            torch.cuda.synchronize()
            if err or digests_to_bytes(got[:rows].cpu().numpy()) != golden:
                raise AssertionError(f"{name} (lanes {lanes}) differs from plain or hashlib at the witness rows")
            row[key + "max_abs_err"] = err
        device_us = _split_lanes_us(name, args, floor=True)
        for key, lanes in (("one_lane_", 1), ("four_lanes_", 4)):
            row[key + "ms"] = _cuda_ms(lambda lanes=lanes: on_lanes(*args, lanes), reps=20)
            row[key + "device_ms"] = _us_ms(device_us[lanes])
            row[key + "floor_ms"] = _us_ms(device_us[f"floor {lanes}"])
        picked = "four_lanes_" if row["lanes"] == 4 else "one_lane_"
        for key in ("ms", "device_ms", "floor_ms"):
            row[key] = row[picked + key]
        out[name] = row
    return out


def _us_ms(us: "float | None") -> "float | None":
    return us / 1e3 if us is not None else None


def b2b_floor(rows: int, lanes: int, device) -> torch.Tensor:
    """`csrc/blake2b_study.cu`'s store-only kernel at a blake2b kernel's
    launch shape for ``rows`` rows and ``lanes`` lanes a message: the
    launch floor."""
    out = torch.empty((rows, 8), dtype=torch.int32, device=device)
    if rows:
        launch(B2B_STUDY, "blake2b_store_floor", [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2,
               [rows, lanes], [out], device, _raw_launches)
    return out


def _split_lanes_us(name: str, args: tuple, floor: bool = False) -> dict:
    """Device µs a call of the split kernel ``name`` over ``args`` with one
    and with four lanes a message (keys 1 and 4), and with ``floor`` the
    store-only kernel at each one's launch shape ("floor 1", "floor 4"):
    the cases take turns in one `_device_us_each` session, each over a
    copy of the inputs of its own."""
    on_lanes = getattr(blake2b, name + "_on_lanes")
    rows, device = args[0].shape[0], args[0].device
    cases = {
        lanes: (lambda *a, lanes=lanes: on_lanes(*a, lanes), [tuple(a.clone() for a in args)], kernel)
        for lanes, kernel in ((1, "blake2b256_kernel"), (4, "blake2b256_quad_kernel"))
    }
    if floor:
        for lanes in (1, 4):
            cases[f"floor {lanes}"] = (lambda lanes=lanes: b2b_floor(rows, lanes, device), [()],
                                       "blake2b_store_floor_" + ("lane" if lanes == 1 else "quad"))
    # a session now and then sees no device time (late in a long run it
    # saw none for most of 41 sessions); take the first that sees all
    for _ in range(3):
        us = _device_us_each(cases)
        if all(v is not None for v in us.values()):
            break
    return us


def split_crossover(case: "KernelCase") -> "list[dict]":
    """The kernel phase's single- or two-block case with one and with four
    lanes a message over its first `SPLIT_SWEEP` rows: each equal to the
    kernel's digests of those rows, then timed by CUDA events over 20 warm
    back-to-back calls and by its device time (`_split_lanes_us`)."""
    name = case.name
    on_lanes = getattr(blake2b, name + "_on_lanes")
    digests = getattr(blake2b, name)(*case.args)
    sweep = []
    for n in SPLIT_SWEEP:
        part = tuple(a[:n] for a in case.args)
        row = {"rows": n, "picked": blake2b.lanes_for_rows(n, name)}
        for lanes in (1, 4):
            if not torch.equal(on_lanes(*part, lanes), digests[:n]):
                raise AssertionError(f"{name} at {n} rows, {lanes} lanes: differs from the kernel phase's")
            row[f"lanes_{lanes}_ms"] = _cuda_ms(lambda lanes=lanes: on_lanes(*part, lanes), reps=20)
        device_us = _split_lanes_us(name, part)
        for lanes in (1, 4):
            row[f"lanes_{lanes}_device_ms"] = _us_ms(device_us[lanes])
        sweep.append(row)
    return sweep


def blocks_crossover(case: "KernelCase") -> "list[dict]":
    """`blake2b256_blocks` with one and with four lanes a message over the
    first `BLOCKS_SWEEP` rows of the kernel phase's multi-block case, each
    equal to the kernel's digests of those rows, timed by CUDA events over
    20 back-to-back calls."""
    full = blake2b.blake2b256_blocks(*case.args)
    sweep = []
    for n in BLOCKS_SWEEP:
        args = tuple(a[:n] for a in case.args)
        row = {"rows": n}
        for lanes in (1, 4):
            if not torch.equal(blake2b.blake2b256_blocks_on_lanes(*args, lanes), full[:n]):
                raise AssertionError(f"blake2b256_blocks at {n} rows, {lanes} lanes: differs from the kernel phase's")
            row[f"lanes_{lanes}_ms"] = _cuda_ms(
                lambda args=args, lanes=lanes: blake2b.blake2b256_blocks_on_lanes(*args, lanes), reps=20
            )
        sweep.append(row)
    return sweep


def _staged_verify(backend, seen: "list | None" = None):
    """The counterpart of the JAX package's ``bench.py`` ``_staged_verify``
    as a ``verify_chunk`` closure: the witness CID recompute on the card
    (``verify_block_cids`` over the chunk's blake2b blocks), then the
    batched replay with the card's TxMeta recompute; returns (verdicts,
    stage seconds). Each chunk bundle it verifies is appended to ``seen``
    (list appends are atomic across the verify workers)."""

    accept = TrustPolicy.accept_all()

    def verify_chunk(bundle):
        if seen is not None:
            seen.append(bundle)
        stages = {}
        t0 = time.perf_counter()
        chain = [b for b in bundle.blocks if b.cid.mh_code == BLAKE2B_256]
        if chain and not backend.verify_block_cids([b.cid.digest for b in chain], [b.data for b in chain]):
            raise ValueError("witness CID mismatch")
        stages["verify_cids"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = load_witness_store(bundle.blocks, verify_cids=False)
        stages["load_witness"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = verify_event_proof(
            EventProofBundle(proofs=bundle.event_proofs, blocks=bundle.blocks),
            accept.verify_parent_tipset, accept.verify_child_header,
            store=store, hash_backend=backend,
        )
        stages["verify_replay"] = time.perf_counter() - t0
        return results, stages

    return verify_chunk


OVERLAP_STAGES = ("range_scan", "range_match", "range_record", "range_merge", "range_verify")


def _overlapped_run(store, pairs, spec, chunk_size, budget, backend, seen=None):
    """One run of the overlapped driver, counts from 0: (merged bundle,
    per-chunk (verdicts, stage s), metrics, wall ms, launches); the chunk
    bundles it verified go to ``seen``."""
    gc.collect()
    metrics = Metrics()
    _reset_counts()
    t0 = time.perf_counter()
    merged, chunk_out = generate_and_verify_range_overlapped(
        store, pairs, spec, chunk_size=chunk_size, verify_chunk=_staged_verify(backend, seen),
        match_backend=backend, metrics=metrics, threads=budget.total,
        scan_threads=budget.scan_workers, record_workers=budget.record_workers,
        verify_workers=budget.verify_workers,
    )
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return merged, chunk_out, metrics, wall_ms, _counts()


def _check_overlapped(label, merged, chunk_out, metrics, expected_json, whole, recording, seen, device, plain_cache):
    """A run of the overlapped driver: its bytes, its verdicts, no fallback
    and no retried scan, and every kernel result it recorded held against
    the plain versions; then each kernel is held against its plain version
    at each verified chunk bundle's shapes. Returns what was checked."""
    if merged.to_json() != expected_json:
        raise AssertionError(f"{label}: the merged bundle differs from the chunked driver's")
    flat = [v for verdicts, _ in chunk_out for v in verdicts]
    if not all(flat) or flat != whole:
        raise AssertionError(f"{label}: per-chunk verdicts differ from whole-bundle verification")
    for counter in ("range_pipeline_serial_fallback", "range_scan_retries"):
        if metrics.counter_value(counter):
            raise AssertionError(f"{label}: {counter} = {metrics.counter_value(counter)} on the card host")
    with_chain = sum(any(b.cid.mh_code == BLAKE2B_256 for b in bundle.blocks) for bundle in seen)
    if len(seen) != len(chunk_out) or len(recording.cid_batches) != with_chain:
        raise AssertionError(
            f"{label}: {len(seen)} chunks verified, {len(recording.cid_batches)} witness "
            f"batches recorded, for {len(chunk_out)} chunks ({with_chain} with blake2b blocks)"
        )
    checked = _check_recorded(label, recording, plain_cache)
    for bundle in seen:
        _check_witness_shapes(bundle.blocks, device)
    _log(f"{label}: kernel results equal to plain at the path's shapes: {checked}")
    return checked


def overlapped_path(world, device, serial_proofs_per_s: float) -> dict:
    """The event path's world through the generate ∥ verify driver, the
    thread budget of this host, then its unfused rerun."""
    store, pairs, n_matching = world
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    if budget.scan_workers * budget.native_scan_threads > budget.total:
        raise AssertionError(f"thread budget oversubscribes: {budget}")
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    # what the overlapped run must reproduce (launches outside any counted window)
    chunk_bundles: list = []
    chunked = generate_event_proofs_for_range_chunked(
        store, pairs, spec, chunk_size=chunk_size, match_backend=backend, on_chunk=chunk_bundles.append
    )
    expected_json = chunked.to_json()
    whole = verify_proof_bundle(chunked, TrustPolicy.accept_all(), cid_backend=backend).event_results
    if len(whole) != n_matching or not all(whole):
        raise AssertionError("overlapped event path: whole-bundle verification failed")
    # the same chunk verifications one after another, nothing else running:
    # what a chunk's verify costs without the other stages' threads
    alone_ms: dict = {}
    verify_chunk = _staged_verify(backend)
    for bundle in chunk_bundles:
        for name, seconds in verify_chunk(bundle)[1].items():
            alone_ms[name] = alone_ms.get(name, 0.0) + seconds * 1e3

    plain_cache: dict = {}
    recording, seen = _RecordingBackend(backend), []
    with _native_branches("overlapped event path", EVENT_BRANCHES):
        merged, chunk_out, metrics, wall_ms, launches = _overlapped_run(
            store, pairs, spec, chunk_size, budget, recording, seen
        )
    present = [name for name, v in _classes(merged.blocks).items() if v]
    _require_launched("overlapped event path", launches, present)
    checked = _check_overlapped(
        "overlapped event path", merged, chunk_out, metrics, expected_json, whole, recording, seen,
        device, plain_cache,
    )
    snap = metrics.snapshot()
    verify_stage_ms: dict = {}
    for _, stages in chunk_out:
        for name, seconds in stages.items():
            verify_stage_ms[name] = verify_stage_ms.get(name, 0.0) + seconds * 1e3

    (_, _, profiled_metrics, profiled_wall_ms, _), busy_ms = _profiled(
        lambda: _overlapped_run(store, pairs, spec, chunk_size, budget, backend)
    )

    u_recording, u_seen = _RecordingBackend(backend), []
    with _env("IPC_SCAN_FUSED_MATCH", "0"):
        u_merged, u_out, u_metrics, u_wall_ms, u_launches = _overlapped_run(
            store, pairs, spec, chunk_size, budget, u_recording, u_seen
        )
    if u_launches["event_match_mask_fp"] < 1:
        raise AssertionError(f"overlapped unfused rerun: no fingerprint mask launch ({u_launches})")
    u_checked = _check_overlapped(
        "overlapped unfused rerun", u_merged, u_out, u_metrics, expected_json, whole, u_recording,
        u_seen, device, plain_cache,
    )
    if u_checked["event_match_mask_fp"]["calls"] != u_launches["event_match_mask_fp"]:
        raise AssertionError(f"overlapped unfused rerun: masks recorded {u_checked}, launched {u_launches}")
    return {
        "pairs": len(pairs),
        "proofs": len(merged.event_proofs),
        "chunk_size": chunk_size,
        "chunks": len(chunk_out),
        "budget": dataclasses.asdict(budget),
        "wall_ms": wall_ms,
        "proofs_per_s": len(merged.event_proofs) / wall_ms * 1e3,
        "serial_proofs_per_s": serial_proofs_per_s,
        "overlap_efficiency": snap.get("overlap_efficiency"),
        "stage_busy_ms": {k: v["total_s"] * 1e3 for k, v in snap["timers"].items()},
        "stage_wall_ms": {k: v["wall_s"] * 1e3 for k, v in snap["timers"].items()},
        "verify_chunk_ms": verify_stage_ms,
        "verify_chunks_alone_ms": alone_ms,
        "launches": launches,
        "checked": checked,
        "profiled_run": {
            "wall_ms": profiled_wall_ms,
            "busy_ms": busy_ms,
            "overlap_efficiency": profiled_metrics.overlap_efficiency(),
        },
        "unfused": {
            "wall_ms": u_wall_ms,
            "proofs_per_s": len(u_merged.event_proofs) / u_wall_ms * 1e3,
            "overlap_efficiency": u_metrics.overlap_efficiency(),
            "stage_busy_ms": {k: v * 1e3 for k, v in u_metrics.stage_s.items()},
            "counters": {
                k: u_metrics.counter_value(k) for k in ("range_match_coalesced", "range_scan_retries")
            },
            "launches": u_launches,
            "checked": u_checked,
        },
        "host": _host_info(),
    }


def _storage_world(n_contracts: int, n_slots: int, backend):
    """BASELINE config 3's contracts: slot keys hashed on the card, values
    ``(i % 251).to_bytes(2, "big")``, direct HAMT storage."""
    preimages = [
        ascii_to_bytes32(f"subnet-{c}") + i.to_bytes(32, "big")
        for c in range(n_contracts)
        for i in range(n_slots)
    ]
    keys = backend.keccak256_batch(preimages)
    contracts = [
        ContractFixture(
            actor_id=ACTOR_ID + c,
            storage={keys[c * n_slots + i]: (i % 251).to_bytes(2, "big") for i in range(n_slots)},
        )
        for c in range(n_contracts)
    ]
    world = build_chain(contracts, [], n_filler_actors=N_FILLER_ACTORS)
    specs = [
        MappingSlotSpec(ACTOR_ID + c, f"subnet-{c}", i)
        for c in range(n_contracts)
        for i in range(n_slots)
    ]
    return world, specs, keys, preimages


def _storage_generate(world, specs, backend):
    """The storage proofs of the world's one pair through the range driver's
    storage leg: slot keccaks on the card, one batched C walk of the actors
    tree and one of the storage HAMTs, one C witness materialization. The
    world has no events, so the range's event scan finds none."""
    pairs = [TipsetPair(world.parent, world.child)]
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    return lambda metrics: generate_event_proofs_for_range(
        world.store, pairs, spec, match_backend=backend, metrics=metrics, storage_specs=specs
    )


def storage_path(n_contracts: int, n_slots: int, seed: int, device) -> dict:
    """BASELINE config 3: ``n_contracts`` EVM contracts × ``n_slots``
    mapping slots at one parent/child pair, proved through the range
    driver's storage leg (`generate_storage_proofs_for_pairs`) and verified
    by the batched storage verifier, the hashing on the card."""
    backend = get_backend("gpu")
    t0 = time.perf_counter()
    world, specs, keys, preimages = _storage_world(n_contracts, n_slots, backend)
    rng = np.random.default_rng(seed + 2)
    for k in rng.choice(len(keys), size=min(4096, len(keys)), replace=False):
        if keys[k] != keccak256(preimages[k]):
            raise AssertionError(f"slot key {k} differs from core.hashes.keccak256")
    world_s = time.perf_counter() - t0
    _log(
        f"storage world: {n_contracts} contracts x {n_slots} slots, {len(world.store)} blocks, "
        f"{world_s:.1f} s (slot keys on the card, 4,096 checked against core.hashes.keccak256)"
    )
    with _native_branches(
        "storage path", ["generate_storage_proofs_for_pairs", "verify_storage_proofs_batch"]
    ):
        bundle, result, _, stages, launches = _generate_and_verify(
            _storage_generate(world, specs, backend), backend
        )
    wall_ms = stages["generate_total"] + stages["verify_total"]
    if len(result.storage_results) != len(specs) or not all(result.storage_results):
        raise AssertionError("storage path: a verdict is false")
    expected = [
        ("0x" + keys[k].hex(), "0x" + left_pad_32((k % n_slots % 251).to_bytes(2, "big")).hex())
        for k in range(len(specs))
    ]
    if bundle.event_proofs or [(p.slot, p.value) for p in bundle.storage_proofs] != expected:
        raise AssertionError("storage path: a proof's slot or value is not the fixture's")
    _require_launched("storage path", launches, ["keccak256_single_block", *SIZE_CLASSES])

    verify_cids_s = _verify_cids_s(bundle, backend)
    _check_slot_keccak(preimages, device)
    _check_witness_shapes(bundle.blocks, device)
    _reject_flipped_blocks(bundle, backend)
    _reject_changed_value(bundle)
    return {
        "contracts": n_contracts,
        "slots": len(specs),
        "proofs": len(bundle.storage_proofs),
        "witness_blocks": {name: len(v) for name, v in _classes(bundle.blocks).items()},
        "stage_ms": dict(stages, world_build=world_s * 1e3, verify_cids=verify_cids_s * 1e3),
        "proofs_per_s": len(bundle.storage_proofs) / wall_ms * 1e3,
        "launches": launches,
        "host": _host_info(),
    }


def mixed_range(n_pairs: int, device) -> dict:
    """The topdown nonce slot proved at every pair of a small event range
    through the native range branches, the range's slot keccak hashed once
    on the card. The range world's contract has an empty storage HAMT, so
    every proof reads value 0 at any slot: the slot itself is checked
    against the host keccak."""
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    backend = get_backend("gpu")
    spec = MappingSlotSpec(ACTOR_ID, TOPIC1, 0)

    def generate(metrics):
        return generate_event_proofs_for_range(
            store, pairs, EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID), match_backend=backend,
            metrics=metrics, storage_specs=[spec],
        )

    branches = [*EVENT_BRANCHES, "generate_storage_proofs_for_pairs", "verify_storage_proofs_batch"]
    with _native_branches("mixed range", branches):
        bundle, result, _, stages, launches = _generate_and_verify(generate, backend)
    if len(result.storage_results) != n_pairs or len(result.event_results) != n_matching:
        raise AssertionError(
            f"mixed range: {len(result.storage_results)} storage and "
            f"{len(result.event_results)} event verdicts for {n_pairs} pairs, {n_matching} matches"
        )
    if not result.all_valid():
        raise AssertionError("mixed range: a verdict is false")
    slot = "0x" + keccak256(ascii_to_bytes32(TOPIC1) + (0).to_bytes(32, "big")).hex()
    if [p.slot for p in bundle.storage_proofs] != [slot] * n_pairs:
        raise AssertionError("mixed range: a proof's slot is not keccak(key ‖ be32(0))")

    _check_slot_keccak([spec.key32() + spec.slot_index.to_bytes(32, "big")], device)
    present = _check_witness_shapes(bundle.blocks, device)
    _require_launched("mixed range", launches, ["keccak256_single_block", *present])
    _reject_changed_value(bundle)
    return {
        "pairs": n_pairs,
        "storage_proofs": len(bundle.storage_proofs),
        "event_proofs": len(bundle.event_proofs),
        "stage_ms": stages,
        "launches": launches,
    }


def resumable_mixed_range(n_pairs: int, chunk_size: int, device) -> dict:
    """The mixed range through the pipelined driver with a checkpoint
    directory and a job journal; a second run resumes every chunk."""
    store, pairs, _ = build_range_world(n_pairs, 16, 4, 0.01)
    backend = _RecordingBackend(get_backend("gpu"))
    specs = [MappingSlotSpec(ACTOR_ID, TOPIC1, 0)]
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    n_chunks = -(-n_pairs // chunk_size)
    runs = []
    with tempfile.TemporaryDirectory() as checkpoint_dir, tempfile.TemporaryDirectory() as job_dir:
        for _ in range(2):
            metrics = Metrics()
            _reset_counts()
            t0 = time.perf_counter()
            bundle = generate_event_proofs_for_range_pipelined(
                store, pairs, spec, chunk_size=chunk_size, match_backend=backend, metrics=metrics,
                storage_specs=specs, checkpoint_dir=checkpoint_dir, job_dir=job_dir,
            )
            torch.cuda.synchronize()
            runs.append((bundle, metrics, (time.perf_counter() - t0) * 1e3, _counts()))
    (first, m1, ms1, l1), (second, m2, ms2, l2) = runs
    if second.to_json() != first.to_json():
        raise AssertionError("resumable mixed range: the resumed bundle differs")
    if m1.counter_value("range_chunks_generated") != n_chunks or m2.counter_value("range_chunks_resumed") != n_chunks:
        raise AssertionError(f"resumable mixed range: counters {m1.counters} / {m2.counters}")
    if m2.counter_value("range_chunks_generated") or m1.counter_value("range_pipeline_serial_fallback"):
        raise AssertionError(f"resumable mixed range: counters {m1.counters} / {m2.counters}")
    # the resumed run's only launch is the up-front slot keccak of the
    # storage leg, which the pipelined driver re-proves (it journals event
    # chunks only, as the reference does)
    if {k: v for k, v in l2.items() if v} != {"keccak256_single_block": 1}:
        raise AssertionError(f"resumable mixed range: the resumed run launched {l2}")
    result = verify_proof_bundle(first, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend)
    if len(result.storage_results) != n_pairs or not result.all_valid():
        raise AssertionError("resumable mixed range: a verdict is false")
    # the slot keccak of both runs (one batch each), and the verification's
    # blake2b batches, as the kernels computed them, against the plain versions
    _check_slot_keccak([s.key32() + s.slot_index.to_bytes(32, "big") for s in specs], device)
    checked = _check_recorded("resumable mixed range", backend, {})
    if checked["keccak"]["batches"] != 2:
        raise AssertionError(f"resumable mixed range: {checked['keccak']} slot keccak batches, expected 2")
    return {
        "pairs": n_pairs,
        "chunks": n_chunks,
        "checked": checked,
        "storage_proofs": len(first.storage_proofs),
        "event_proofs": len(first.event_proofs),
        "first_ms": ms1,
        "resumed_ms": ms2,
        "counters": {"first": m1.counters, "resumed": m2.counters},
        "launches": l1,
        "resumed_launches": l2,
    }


def pure_python_paths(n_pairs: int, n_contracts: int, n_slots: int) -> dict:
    """Run in a process started with ``IPC_PROOFS_NO_NATIVE=1``: the
    slice 1–2 pure-Python branches on the card (Python scan with the flat
    mask on the card, scalar pass 2, `generate_storage_proofs_batch`, scalar
    replays), each path's bundle digest, stages and launches."""
    if load_scan_ext() is not None or CID is not PurePythonCID:
        raise AssertionError("the pure-Python paths need IPC_PROOFS_NO_NATIVE=1")
    backend = get_backend("gpu")
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    bundle, result, _, stages, launches = _generate_and_verify(
        _event_generate(store, pairs, backend), backend
    )
    if len(result.event_results) != n_matching or not all(result.event_results):
        raise AssertionError("pure event path: a verdict is false")
    _require_launched("pure event path", launches, ["event_match_mask", *SIZE_CLASSES])
    out = {"event": {"digest": bundle.digest(), "proofs": len(bundle.event_proofs),
                     "stage_ms": stages, "launches": launches}}

    world, specs, _, _ = _storage_world(n_contracts, n_slots, backend)
    bundle, result, _, stages, launches = _generate_and_verify(
        lambda metrics: generate_storage_proofs_batch(
            world.store, world.parent, world.child, specs, hash_backend=backend, metrics=metrics
        ),
        backend,
    )
    if len(result.storage_results) != len(specs) or not all(result.storage_results):
        raise AssertionError("pure storage path: a verdict is false")
    _require_launched("pure storage path", launches, ["keccak256_single_block", *SIZE_CLASSES])
    out["storage"] = {"digest": bundle.digest(), "proofs": len(bundle.storage_proofs),
                      "stage_ms": stages, "launches": launches}
    return out


def pure_python_phase(n_pairs: int, n_contracts: int, n_slots: int) -> dict:
    """The pure-Python paths in a child process (the universe is chosen once
    per process), held against the native branches on the same worlds: the
    bundle digests must be equal."""
    cmd = [
        sys.executable, __file__, "--pure-python-paths",
        "--pairs", str(n_pairs), "--contracts", str(n_contracts), "--slots", str(n_slots),
    ]
    env = dict(os.environ, IPC_PROOFS_NO_NATIVE="1")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pure-Python paths failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    pure = json.loads(proc.stdout.strip().splitlines()[-1])

    backend = get_backend("gpu")
    store, pairs, _ = build_range_world(n_pairs, 16, 4, 0.01)
    native_event = _event_generate(store, pairs, backend)(Metrics()).digest()
    world, specs, _, _ = _storage_world(n_contracts, n_slots, backend)
    native_storage = _storage_generate(world, specs, backend)(Metrics()).digest()
    if pure["event"]["digest"] != native_event:
        raise AssertionError(f"{n_pairs}-pair event bundle: pure-Python and native digests differ")
    if pure["storage"]["digest"] != native_storage:
        raise AssertionError(
            f"{n_contracts}x{n_slots} storage bundle: pure-Python and native digests differ"
        )
    _log(
        f"pure-Python paths (child process, {child_s:.1f} s): {n_pairs}-pair event bundle "
        f"sha256 {native_event} and {n_contracts}x{n_slots} storage bundle sha256 "
        f"{native_storage} equal the native branches'"
    )
    return pure


# --------------------------------------------------------------------------
# slice 5: the cold read path
# --------------------------------------------------------------------------

COLD_PREFIXES = ("rpc.", "fetch.", "verify.", "storex.")
# the cold read, warm restart and lying disk run the event world's first
# 256 pairs (cut in depth to keep the script's time: 1,024 until phase 32
# came; the CLI's range reads 1,024 pairs cold)
COLD_PAIRS = 256
LYING_NODE_PAIRS = 256
LYING_NODE_RUNS = 4  # 8 until phase 32 came
FORGED_FRAMES = 64
# the mixed-multihash sweep: (multihash code, blocks, longest block)
UNKNOWN_CODE = 0x15
MIXED_FAMILIES = (
    (BLAKE2B_256, 32_768, 520),
    (KECCAK_256, 32_768, 520),
    (SHA2_256, 8_192, 520),
    (IDENTITY, 2_048, 64),
    (UNKNOWN_CODE, 512, 520),
)


def _spec() -> EventProofSpec:
    return EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)


def _cold_counters(metrics: Metrics) -> dict:
    return {k: v for k, v in sorted(metrics.counters.items()) if k.startswith(COLD_PREFIXES)}


class _Calls(list):
    """(blocks, wall ms) per call, and ``classes``: the number of blake2b
    size classes of each call's blocks (the kernel dispatches a call of
    two or more blocks makes on the device lane)."""

    def __init__(self):
        super().__init__()
        self.classes: "list[int]" = []


@contextlib.contextmanager
def _verify_calls(module):
    """Record every `verify_blocks_batch` call ``module`` (the fetch plane
    or the segment store) makes, from any thread: (blocks, wall ms)."""
    calls = _Calls()
    original = module.verify_blocks_batch

    def spy(cids, blocks, *args, **kwargs):
        t0 = time.perf_counter()
        out = original(cids, blocks, *args, **kwargs)
        # one append per list under the GIL; the pair may interleave
        # between threads, so only the sums of ``classes`` are read
        calls.append((len(blocks), (time.perf_counter() - t0) * 1e3))
        calls.classes.append(len({size_class(len(b)) for b in blocks}) if len(blocks) >= 2 else 0)
        return out

    module.verify_blocks_batch = spy
    try:
        yield calls
    finally:
        module.verify_blocks_batch = original


def _no_retries(label: str, metrics: Metrics) -> None:
    for counter in ("range_scan_retries", "range_pipeline_serial_fallback", "rpc.retries",
                    "rpc.integrity_failures", "fetch.speculative_integrity_drops"):
        if metrics.counter_value(counter):
            raise AssertionError(f"{label}: {counter} = {metrics.counter_value(counter)}")


def _cold_run(store, pairs, store_dir, backend, budget, chunk_size, session=None, scan_retries=2,
              metrics=None, speculate_depth=1):
    """One pipelined run over the cold read stack, counts from 0: hermetic
    Lotus node → `LotusClient` → `FetchPlane` (every landed wave verified on
    ``backend``) → `TieredBlockstore` over a `SegmentStore` in ``store_dir``
    (batch verify on ``backend``). Returns (bundle, metrics, wall ms,
    launches)."""
    gc.collect()
    metrics = Metrics() if metrics is None else metrics
    client = LotusClient("http://lotus.local", session=session or LocalLotusSession(store), metrics=metrics)
    plane = FetchPlane(
        client, speculate_depth=speculate_depth, backend=backend, metrics=metrics
    )
    disk = SegmentStore(store_dir, backend=backend, metrics=metrics)
    tier = TieredBlockstore(PlaneBlockstore(plane), disk, metrics=metrics)
    plane.set_local(tier)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        bundle = generate_event_proofs_for_range_pipelined(
            tier, pairs, _spec(), chunk_size=chunk_size, match_backend=backend, metrics=metrics,
            threads=budget.total, scan_threads=budget.scan_workers, record_workers=budget.record_workers,
            scan_retries=scan_retries,
        )
        torch.cuda.synchronize()
    finally:
        plane.close()
        disk.close()
    return bundle, metrics, (time.perf_counter() - t0) * 1e3, _counts()


def cold_read_path(world, device, root: str) -> dict:
    """BASELINE config 2 read cold through the hermetic node, the fetch
    plane and the disk tier by the pipelined driver at the host's thread
    budget, every landed wave of two or more blocks verified on the card
    (``IPC_VERIFY_MIN_BYTES=0``): the in-memory path's bytes, the lane
    split, every recorded kernel call held against the plain versions."""
    store, pairs, n_matching = world
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend).to_json()
    recording = _RecordingBackend(backend)
    with _env("IPC_VERIFY_MIN_BYTES", "0"), _verify_calls(fetchplane_mod) as waves:
        bundle, metrics, wall_ms, launches = _cold_run(
            store, pairs, os.path.join(root, "cold"), recording, budget, chunk_size
        )
    if bundle.to_json() != expected:
        raise AssertionError("cold read: the bundle differs from the in-memory event path's")
    _no_retries("cold read", metrics)
    # the tier has no raw map, so the scan is the Python walk and the
    # predicate the flat mask on the card (as in the reference)
    _require_launched("cold read", launches, [*SIZE_CLASSES, "event_match_mask"])
    single = sum(n for n, _ in waves if n == 1)
    multi = [n for n, _ in waves if n >= 2]
    lanes = {
        "verify.batch_calls": len(waves),
        "verify.scalar_blocks": single,
        "verify.device_calls": sum(waves.classes),
        "verify.device_blocks": sum(multi),
    }
    got = {k: metrics.counter_value(k) for k in lanes}
    if got != lanes:
        raise AssertionError(f"cold read: lane split {got}, waves say {lanes}")
    checked = _check_recorded("cold read", recording, {})
    if checked["blake2b"]["batches"] != len(multi):
        raise AssertionError(f"cold read: {checked['blake2b']} recorded for {len(multi)} device waves")
    _log(f"cold read: every device wave equal to plain and to hashlib: {checked}")

    with _env("IPC_VERIFY_MIN_BYTES", "0"):
        (again, p_metrics, p_wall_ms, _), busy_ms = _profiled(
            lambda: _cold_run(store, pairs, os.path.join(root, "cold-profiled"), backend, budget, chunk_size)
        )
    shutil.rmtree(os.path.join(root, "cold-profiled"))
    if again.to_json() != expected:
        raise AssertionError("cold read (profiled repeat): the bundle differs")
    # the same run at the default crossover, what the lane's routing costs:
    # waves of at most 64 blocks stay below 256 KiB, so all take the host lane
    with _verify_calls(fetchplane_mod) as d_waves:
        default, d_metrics, d_wall_ms, d_launches = _cold_run(
            store, pairs, os.path.join(root, "cold-default"), backend, budget, chunk_size
        )
    shutil.rmtree(os.path.join(root, "cold-default"))
    if default.to_json() != expected:
        raise AssertionError("cold read (default crossover): the bundle differs")
    _no_retries("cold read (default crossover)", d_metrics)
    return {
        "pairs": len(pairs),
        "proofs": len(bundle.event_proofs),
        "chunk_size": chunk_size,
        "budget": dataclasses.asdict(budget),
        "wall_ms": wall_ms,
        "proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
        "stage_busy_ms": {k: v * 1e3 for k, v in metrics.stage_s.items()},
        "counters": _cold_counters(metrics),
        "waves": {"total": len(waves), "single_block": single, "multi_block": len(multi),
                  "largest": max(multi, default=0),
                  "verify_ms": sum(ms for _, ms in waves)},
        "checked": checked,
        "launches": launches,
        "profiled_run": {"wall_ms": p_wall_ms, "busy_ms": busy_ms,
                         "proofs_per_s": len(again.event_proofs) / p_wall_ms * 1e3},
        "default_crossover": {
            "wall_ms": d_wall_ms,
            "proofs_per_s": len(default.event_proofs) / d_wall_ms * 1e3,
            "verify_ms": sum(ms for _, ms in d_waves),
            "counters": {k: v for k, v in _cold_counters(d_metrics).items() if k.startswith("verify.")},
            "launches": d_launches,
        },
        "host": _host_info(),
    }


def _open_swept(store_dir: str, backend, metrics: Metrics):
    """Open a segment store with the sweep at open on ``backend`` at the
    default crossover: (store, open ms, sweep calls)."""
    with _verify_calls(segments_mod) as calls:
        _reset_counts()
        t0 = time.perf_counter()
        disk = SegmentStore(store_dir, verify_scan=True, backend=backend, metrics=metrics)
        torch.cuda.synchronize()
        open_ms = (time.perf_counter() - t0) * 1e3
    return disk, open_ms, calls


def warm_restart(world, root: str) -> dict:
    """Reopen the cold run's disk with the sweep at open on the card, then
    generate again through a fresh plane and tier: the same bytes and no
    RPC call without speculation; at the cold run's depth 1 the same bytes,
    and the speculative fetches that reach the node counted."""
    store, pairs, _ = world
    backend = get_backend("gpu")
    recording = _RecordingBackend(backend)
    store_dir = os.path.join(root, "cold")
    seg_bytes = sum(os.path.getsize(os.path.join(store_dir, n)) for n in os.listdir(store_dir) if n.endswith(".blk"))
    metrics = Metrics()
    disk, open_ms, calls = _open_swept(store_dir, recording, metrics)
    sweep_launches = _counts()
    n_blocks = len(disk)
    if metrics.counter_value("storex.integrity_evictions"):
        raise AssertionError(f"warm restart: the sweep evicted {metrics.counters}")
    n_segments = len([n for n in os.listdir(store_dir) if n.endswith(".blk")])
    if (len(calls) != n_segments or sum(n for n, _ in calls) != n_blocks
            or metrics.counter_value("verify.device_blocks") != n_blocks):
        raise AssertionError(f"warm restart: sweep calls {calls} for {n_blocks} blocks ({metrics.counters})")
    _require_launched("warm restart sweep", sweep_launches, SIZE_CLASSES)
    checked = _check_recorded("warm restart sweep", recording, {})
    swept = [len(m) for messages, _ in recording.batches for m in messages]
    disk.close()

    budget = resolve_thread_budget()
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend).to_json()
    # speculation off: no want may reach the node
    bundle, g_metrics, wall_ms, launches = _cold_run(
        store, pairs, store_dir, backend, budget, chunk_size, speculate_depth=0
    )
    if bundle.to_json() != expected:
        raise AssertionError("warm restart: the bundle differs from the in-memory event path's")
    if g_metrics.counter_value("rpc.calls") or g_metrics.counter_value("fetch.wants"):
        raise AssertionError(f"warm restart: the warm run reached the node: {_cold_counters(g_metrics)}")
    _no_retries("warm restart", g_metrics)
    # the cold run's depth 1: walkers offer links that the cold plane dropped
    # at its queue cap and no walk reads, and the plane fetches them, as the
    # reference's does (tests/test_torch_fetchplane.py::TestWarmRestartSpeculation);
    # every demand is still served from the disk
    spec_bundle, s_metrics, s_wall_ms, _ = _cold_run(store, pairs, store_dir, backend, budget, chunk_size)
    if spec_bundle.to_json() != expected:
        raise AssertionError("warm restart (depth 1): the bundle differs from the in-memory event path's")
    if s_metrics.counter_value("fetch.wants") != s_metrics.counter_value("fetch.speculative_wants"):
        raise AssertionError(f"warm restart (depth 1): a demand reached the node: {_cold_counters(s_metrics)}")
    _no_retries("warm restart (depth 1)", s_metrics)
    return {
        "blocks": n_blocks,
        "block_bytes": sum(swept),
        "segment_bytes": seg_bytes,
        "segments": n_segments,
        "by_class": {name: sum(size_class(n) == name for n in swept) for name in SIZE_CLASSES},
        "open_ms": open_ms,
        "sweep_verify_ms": sum(ms for _, ms in calls),
        "sweep_blocks_per_s": n_blocks / sum(ms for _, ms in calls) * 1e3,
        "sweep_launches": sweep_launches,
        "checked": checked,
        "generate_wall_ms": wall_ms,
        "generate_proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
        "generate_counters": _cold_counters(g_metrics),
        "launches": launches,
        "speculating": {
            "wall_ms": s_wall_ms,
            "proofs_per_s": len(spec_bundle.event_proofs) / s_wall_ms * 1e3,
            "rpc_calls": s_metrics.counter_value("rpc.calls"),
            "counters": _cold_counters(s_metrics),
        },
    }


def _frames(store_dir: str) -> "list[tuple[str, int, int, bytes]]":
    """(segment path, offset, frame length, raw CID) of every frame."""
    out = []
    for name in sorted(os.listdir(store_dir)):
        if not name.endswith(".blk"):
            continue
        path = os.path.join(store_dir, name)
        with open(path, "rb") as fh:
            data = fh.read()
        off = 0
        while off < len(data):
            _, length, _ = FRAME_HEADER.unpack_from(data, off)
            payload = data[off + FRAME_HEADER.size : off + FRAME_HEADER.size + length]
            (cid_len,) = struct.unpack_from("<H", payload, 0)
            out.append((path, off, FRAME_HEADER.size + length, payload[2 : 2 + cid_len]))
            off += FRAME_HEADER.size + length
    return out


def _forge(path: str, off: int, frame_len: int) -> None:
    """Change a frame's last block byte and write a valid CRC over it: the
    CRC passes, only the multihash can tell."""
    with open(path, "r+b") as fh:
        fh.seek(off)
        payload = bytearray(fh.read(frame_len)[FRAME_HEADER.size :])
        payload[-1] ^= 0xFF
        fh.seek(off)
        fh.write(FRAME_HEADER.pack(SEGMENT_MAGIC, len(payload), zlib.crc32(bytes(payload))) + bytes(payload))


def lying_disk(world, root: str, seed: int) -> dict:
    """Forge frames of the cold run's disk at seeded indices: the sweep at
    open evicts exactly that set, and reads through the tier refetch and
    repair each one."""
    store, _, _ = world
    backend = get_backend("gpu")
    store_dir = os.path.join(root, "cold")
    frames = _frames(store_dir)
    rng = np.random.default_rng(seed + 5)
    picked = sorted(int(i) for i in rng.choice(len(frames), size=FORGED_FRAMES, replace=False))
    for i in picked:
        _forge(*frames[i][:3])
    forged = {frames[i][3] for i in picked}
    recording = _RecordingBackend(backend)
    metrics = Metrics()
    disk, open_ms, _ = _open_swept(store_dir, recording, metrics)
    sweep_launches = _counts()
    try:
        evicted = {raw for _, _, _, raw in frames if not disk.contains(CID.from_bytes(raw))}
        if evicted != forged or metrics.counter_value("storex.integrity_evictions") != len(forged):
            raise AssertionError(
                f"lying disk: the sweep evicted {len(evicted)} frames, {len(evicted & forged)} of the "
                f"{len(forged)} forged ({metrics.counters})"
            )
        _require_launched("lying disk sweep", sweep_launches, SIZE_CLASSES)
        checked = _check_recorded("lying disk sweep", recording, {})
        client = LotusClient("http://lotus.local", session=LocalLotusSession(store), metrics=metrics)
        plane = FetchPlane(client, speculate_depth=0, backend=backend, metrics=metrics)
        tier = TieredBlockstore(PlaneBlockstore(plane), disk, metrics=metrics)
        plane.set_local(tier)
        before = metrics.counter_value("rpc.calls")
        try:
            for raw in sorted(forged):
                cid = CID.from_bytes(raw)
                if tier.get(cid) != store.get(cid) or disk.get(cid) != store.get(cid):
                    raise AssertionError(f"lying disk: {cid} was not repaired")
        finally:
            plane.close()
        refetched = metrics.counter_value("rpc.calls") - before
        if refetched != len(forged):
            raise AssertionError(f"lying disk: {refetched} RPC calls to repair {len(forged)} frames")
    finally:
        disk.close()
    return {"frames": len(frames), "forged": len(forged), "evicted": len(evicted), "open_ms": open_ms,
            "refetched": refetched, "launches": sweep_launches, "checked": checked,
            "counters": _cold_counters(metrics)}


def lying_node(n_pairs: int, root: str, seed: int) -> dict:
    """A node that flips bits (`FaultySession` over the hermetic node,
    seeded bit-flip plans): each run gives the in-memory path's bytes or a
    typed error, speculative lies are dropped before use, and no forged
    block reaches the disk (a verifying reopen evicts nothing)."""
    store, pairs, _ = build_range_world(n_pairs, 16, 4, 0.01)
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    chunk_size = max(1, n_pairs // 8)
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend).to_json()
    runs = []
    launches: dict = {}
    for run in range(LYING_NODE_RUNS):
        # one endpoint and no failover: each lie in a demand wave costs the
        # chunk a scan retry, so the retries cover every lie of the plan
        plan = FaultPlan(seed * 100 + run, fault_rate=0.1, kinds=("bitflip",), max_faults=16)
        session = FaultySession(LocalLotusSession(store), plan, sleep=lambda s: None)
        store_dir = os.path.join(root, f"lying-node-{run}")
        metrics = Metrics()
        with _env("IPC_VERIFY_MIN_BYTES", "0"):
            try:
                bundle, _, _, run_launches = _cold_run(
                    store, pairs, store_dir, backend, budget, chunk_size, session=session, scan_retries=16,
                    metrics=metrics,
                )
                outcome = "identical" if bundle.to_json() == expected else "DIFFERENT"
                caught = metrics.counter_value("rpc.integrity_failures") + metrics.counter_value(
                    "fetch.speculative_integrity_drops"
                )
                if caught != plan.snapshot()["by_kind"].get("bitflip", 0):
                    raise AssertionError(f"lying node run {run}: {caught} lies caught of {plan.snapshot()}")
            except (IntegrityError, RpcError) as exc:  # a typed refusal is an accepted outcome
                outcome, run_launches = type(exc).__name__, _counts()
        if outcome == "DIFFERENT":
            raise AssertionError(f"lying node run {run}: a completed run gave other bytes")
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
        reopen = Metrics()
        disk, _, _ = _open_swept(store_dir, backend, reopen)
        disk.close()
        if reopen.counter_value("storex.integrity_evictions"):
            raise AssertionError(f"lying node run {run}: a forged block reached the disk ({reopen.counters})")
        runs.append({
            "outcome": outcome,
            "flips": plan.snapshot()["by_kind"].get("bitflip", 0),
            "counters": _cold_counters(metrics),
            "scan_retries": metrics.counter_value("range_scan_retries"),
        })
        shutil.rmtree(store_dir)
    drops = sum(r["counters"].get("fetch.speculative_integrity_drops", 0) for r in runs)
    if not drops or not any(r["outcome"] == "identical" for r in runs):
        raise AssertionError(f"lying node: no speculative drop or no completed run: {runs}")
    return {"pairs": n_pairs, "runs": runs, "speculative_integrity_drops": drops, "launches": launches}


def _host_verdict(item: "tuple[bytes, bytes]") -> "tuple[bool, bytes | None]":
    """`verify_block_bytes` of one (raw CID, block), and the host golden
    digest of a keccak block; run in worker processes (the host keccak is
    pure Python)."""
    raw, data = item
    cid = CID.from_bytes(raw)
    digest = keccak256(data) if cid.mh_code == KECCAK_256 else None
    return verify_block_bytes(cid, data), digest


def _mixed_blocks(seed: int):
    """The sweep's blocks from the seed: (raw CIDs, stored bytes, flipped
    indices). The keccak CIDs are hashed on the card (outside any counted
    window): a wrong kernel gives wrong CIDs, which the host verdicts then
    reject block by block."""
    rng = np.random.default_rng(seed + 6)
    blocks, codes = [], []
    for code, count, longest in MIXED_FAMILIES:
        lengths = rng.integers(1, longest + 1, size=count)
        lengths[0] = 0  # one empty block per family
        seen: set = set()
        for n in lengths:
            data = rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            while data in seen:  # short blocks repeat: one CID, one block
                data = rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            seen.add(data)
            blocks.append(data)
            codes.append(code)
    keccak_rows = [i for i, c in enumerate(codes) if c == KECCAK_256]
    keccak_digests = get_backend("gpu").keccak256_batch([blocks[i] for i in keccak_rows])
    digests = dict(zip(keccak_rows, keccak_digests))
    raws = []
    for i, (code, data) in enumerate(zip(codes, blocks)):
        if code == KECCAK_256:
            cid = CID(1, DAG_CBOR, KECCAK_256, digests[i])
        elif code == UNKNOWN_CODE:
            cid = CID(1, DAG_CBOR, UNKNOWN_CODE, hashlib.sha256(b"unknown %d" % i).digest())
        else:
            cid = CID.hash_of(data, mh_code=code)
        raws.append(cid.to_bytes())
    nonempty = [i for i, data in enumerate(blocks) if data]
    flipped = sorted(int(i) for i in rng.choice(nonempty, size=len(blocks) // 100, replace=False))
    for i in flipped:
        data = bytearray(blocks[i])
        data[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
        blocks[i] = bytes(data)
    return raws, blocks, flipped


def mixed_sweep(root: str, seed: int) -> dict:
    """One segment's worth of blocks of every multihash family, 1 % of them
    with a flipped bit, swept at open on the card: each verdict equal to
    `verify_block_bytes`, the flips the only evictions, both keccak and all
    three blake2b kernels launched."""
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    workers = len(os.sched_getaffinity(0))
    raws, blocks, flipped = _mixed_blocks(seed)
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        host = list(pool.map(_host_verdict, list(zip(raws, blocks)), chunksize=1024))
    store_dir = os.path.join(root, "mixed")
    with SegmentStore(store_dir) as disk:
        for raw, data in zip(raws, blocks):
            disk.put(CID.from_bytes(raw), data)
        if len(disk) != len(raws) or disk.stats()["segments"] != 1:
            raise AssertionError(f"mixed sweep: {disk.stats()} for {len(raws)} blocks")
    build_s = time.perf_counter() - t0
    expected = [ok for ok, _ in host]
    golden_keccak = {data: digest for data, (_, digest) in zip(blocks, host) if digest is not None}

    recording = _RecordingBackend(get_backend("gpu"))
    metrics = Metrics()
    disk, open_ms, calls = _open_swept(store_dir, recording, metrics)
    launches = _counts()
    try:
        kept = [disk.contains(CID.from_bytes(raw)) for raw in raws]
    finally:
        disk.close()
    if kept != expected:
        first = next(i for i, (a, b) in enumerate(zip(kept, expected)) if a != b)
        raise AssertionError(f"mixed sweep: block {first}'s verdict differs from verify_block_bytes")
    evicted = [i for i, ok in enumerate(kept) if not ok]
    if not set(evicted) <= set(flipped) or metrics.counter_value("storex.integrity_evictions") != len(evicted):
        raise AssertionError(f"mixed sweep: evictions outside the flipped blocks ({metrics.counters})")
    unknown_flips = sum(CID.from_bytes(raws[i]).mh_code == UNKNOWN_CODE for i in flipped)
    if len(evicted) != len(flipped) - unknown_flips:
        raise AssertionError(f"mixed sweep: {len(evicted)} evictions for {len(flipped)} flips")
    _require_launched("mixed sweep", launches, [*SIZE_CLASSES, *KECCAK_CLASSES])
    cpu = get_backend("gpu", device="cpu")
    for kind, batches, plain, golden in (
        ("blake2b", recording.batches, cpu.blake2b256_batch, _blake2b),
        ("keccak", recording.keccak_batches, cpu.keccak256_batch, golden_keccak.__getitem__),
    ):
        if len(batches) != 1:
            raise AssertionError(f"mixed sweep: {len(batches)} {kind} calls, expected 1")
        [(messages, digests)] = batches
        if digests != plain(messages) or digests != [golden(m) for m in messages]:
            raise AssertionError(f"mixed sweep: the {kind} call differs from plain or the host")
    return {
        "blocks": len(raws),
        "bytes": sum(len(b) for b in blocks),
        "families": {hex(code): count for code, count, _ in MIXED_FAMILIES},
        "flipped": len(flipped),
        "flipped_unknown_code": unknown_flips,
        "evicted": len(evicted),
        "build_s": build_s,
        "open_ms": open_ms,
        "sweep_verify_ms": calls[0][1],
        "counters": _cold_counters(metrics),
        "launches": launches,
    }


CLI_ENDPOINT = "http://lotus.local/rpc/v1"
CLI_SUBNET = "calib-subnet-1"
CLI_ETH = "0x" + "52" * 20  # resolves through its delegated f410 address
CLI_CHUNK = 512
CLI_SIGNERS = 4  # the seeded F3 power table's size
CLI_CERTS = 2  # certificates in the `cert` chain (4 until phase 32 came)
CLI_CERT_SPAN = 64  # new tipsets each of them finalizes


def _tipset_json(tipset) -> dict:
    """A tipset as `Filecoin.ChainGetTipSetByHeight` answers it."""
    return {
        "Cids": [{"/": str(c)} for c in tipset.cids],
        "Blocks": [
            {
                "Parents": [{"/": str(p)} for p in h.parents],
                "Height": h.height,
                "ParentStateRoot": {"/": str(h.parent_state_root)},
                "ParentMessageReceipts": {"/": str(h.parent_message_receipts)},
                "Messages": {"/": str(h.messages)},
                "Timestamp": h.timestamp,
            }
            for h in tipset.blocks
        ],
        "Height": tipset.height,
    }


class _NodeSession(LocalLotusSession):
    """The hermetic node serving a chain: every height's tipset, the head
    (the chain's last height), the contract's delegated address and its ID;
    each answered method counted
    (the fetch plane's dispatchers post from two threads)."""

    def __init__(self, store, tipsets):
        by_height = {ts.height: ts for ts in tipsets}
        responses = {
            "Filecoin.ChainGetTipSetByHeight": lambda params: _tipset_json(by_height[params[0]]),
            "Filecoin.EthAddressToFilecoinAddress": str(Address.from_eth_address(CLI_ETH)),
            "Filecoin.StateLookupID": f"f0{ACTOR_ID}",
        }
        if tipsets:
            responses["Filecoin.ChainHead"] = {"Height": tipsets[-1].height}
        super().__init__(store, responses)
        self._count_lock = threading.Lock()
        self.methods: "dict[str, int]" = {}

    def _answer(self, req: dict) -> dict:
        with self._count_lock:
            self.methods[req.get("method")] = self.methods.get(req.get("method"), 0) + 1
        return super()._answer(req)


@contextlib.contextmanager
def _cli_node(session, recording):
    """The CLI as a user runs it, with two seams: its `LotusClient` posts to
    the hermetic node (``session``, or ``session[endpoint]`` for a dict of
    nodes by endpoint URL), and its card backend (``--backend gpu``) is
    ``recording``, which records every kernel call for `_check_recorded`."""
    real_client, real_backend = rpc_mod.LotusClient, backend_mod.get_backend

    def get_backend_(name="gpu", device=None, mesh_devices=None):
        if device is not None:
            return real_backend(name, device=device, mesh_devices=mesh_devices)
        if (mesh_devices is None) != (getattr(recording, "mesh", None) is None):
            raise AssertionError(f"the CLI asked for mesh_devices={mesh_devices}; the recording has {recording.mesh}")
        return recording

    def client(endpoint, **kw):
        node = session[endpoint] if isinstance(session, dict) else session
        return real_client(endpoint, session=node, metrics=kw.get("metrics"))

    rpc_mod.LotusClient = client
    backend_mod.get_backend = get_backend_
    try:
        yield
    finally:
        rpc_mod.LotusClient, backend_mod.get_backend = real_client, real_backend


def _cli(label: str, argv, want_rc: int = 0):
    """``ipc_proofs_tpu_torch.cli.main(argv)`` with the process metrics and
    the launch counts from 0: (stdout, wall ms, launches, metrics
    snapshot). Fails unless the exit code is ``want_rc``."""
    get_metrics().reset()
    _reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if rc != want_rc:
        raise AssertionError(f"{label}: exit {rc}, expected {want_rc}: {out.getvalue()[-2000:]}")
    return out.getvalue(), wall_ms, _counts(), get_metrics().snapshot()


def cli_world(n_pairs: int):
    """The event path's world chained into one chain (``build_range_world(
    n_pairs, 16, 4, 0.01, chained=True)``): ``n_pairs + 1`` consecutive
    heights, so the CLI's ``range`` forms exactly ``n_pairs`` pairs."""
    t0 = time.perf_counter()
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01, chained=True)
    tipsets = [pairs[0].parent] + [pair.child for pair in pairs]
    _log(f"cli world: {n_pairs} pairs, {len(tipsets)} heights, {len(store)} blocks, "
         f"{time.perf_counter() - t0:.1f} s")
    return store, pairs, tipsets, n_matching


CLI_RANGE_PAIRS = 1024  # the CLI phases read the chain's first 1,024 pairs (2,048 until phase 32)


def _chain_prefix(world, n_pairs: int):
    """The chained world's first ``n_pairs`` pairs (``n_pairs + 1``
    heights), with its matching receipts counted by the fixture's rule (a
    receipt matches when its global index is a multiple of 100 at
    ``match_rate=0.01``; 16 receipts a pair)."""
    store, pairs, tipsets, _ = world
    return store, pairs[:n_pairs], tipsets[: n_pairs + 1], len(range(0, n_pairs * 16, 100))


def cli_range(world, root: str) -> dict:
    """``range`` over the whole chain through the hermetic node (fetch plane
    at speculate depth 1, every landed wave of two or more blocks verified
    on the card: ``IPC_VERIFY_MIN_BYTES=0``), with the topdown nonce slot
    at every pair, chunks of 512 in a checkpoint directory and the default
    pipeline depth 2: the bytes of `generate_event_proofs_for_range_chunked`
    in memory for the same pairs and specs, the slot keccak, the flat event
    mask and the blake2b kernels launched, every recorded kernel call equal
    to the plain versions; a second run resumes from the checkpoints with
    the same bytes and no ``Filecoin.ChainReadObj``."""
    store, pairs, tipsets, n_matching = world
    backend = get_backend("gpu")
    slot = MappingSlotSpec(ACTOR_ID, CLI_SUBNET, 0)
    expected = generate_event_proofs_for_range_chunked(
        store, pairs, EventProofSpec(SIGNATURE, CLI_SUBNET, ACTOR_ID), chunk_size=CLI_CHUNK,
        match_backend=backend, storage_specs=[slot],
    ).to_json()
    argv = [
        "range", "--endpoint", CLI_ENDPOINT,
        "--from-height", str(tipsets[0].height), "--to-height", str(tipsets[-2].height),
        "--contract", CLI_ETH, "--event-sig", SIGNATURE, "--topic1", CLI_SUBNET,
        "--storage-slot", CLI_SUBNET, "--chunk-size", str(CLI_CHUNK),
        "--checkpoint-dir", os.path.join(root, "cli-checkpoints"), "--backend", "gpu", "--metrics",
    ]
    runs = []
    for run in ("first", "resumed"):
        session = _NodeSession(store, tipsets)
        recording = _RecordingBackend(backend)
        path = os.path.join(root, f"cli-range-{run}.json")
        gc.collect()
        with _cli_node(session, recording), _env("IPC_VERIFY_MIN_BYTES", "0"):
            _, wall_ms, launches, snap = _cli(f"cli range ({run})", argv + ["-o", path])
        with open(path) as fh:
            if fh.read() != expected:
                raise AssertionError(f"cli range ({run}): the bundle differs from the in-memory chunked driver's")
        runs.append((session, recording, wall_ms, launches, snap))
    (session, recording, wall_ms, launches, snap), (r_session, _, r_wall_ms, r_launches, r_snap) = runs
    _require_launched("cli range", launches, [*SIZE_CLASSES, "keccak256_single_block", "event_match_mask"])
    checked = _check_recorded("cli range", recording, {})
    reads = r_session.methods.get("Filecoin.ChainReadObj", 0)
    if reads or r_snap["counters"].get("range_chunks_resumed") != -(-len(pairs) // CLI_CHUNK):
        raise AssertionError(f"cli range (resumed): {reads} ChainReadObj, counters {r_snap['counters']}")
    n_proofs = len(json.loads(expected)["event_proofs"])
    if n_proofs != n_matching:
        raise AssertionError(f"cli range: {n_proofs} event proofs for {n_matching} matching receipts")
    timers = snap["timers"]
    return {
        "pairs": len(pairs),
        "proofs": n_proofs,
        "storage_proofs": len(pairs),
        "wall_ms": wall_ms,
        "proofs_per_s": n_proofs / wall_ms * 1e3,
        "fetch_tipsets_ms": timers["fetch_tipsets"]["total_s"] * 1e3,
        "stage_busy_ms": {k: v["total_s"] * 1e3 for k, v in timers.items()},
        "rpc_calls": snap["counters"].get("rpc.calls", 0),
        "node_methods": session.methods,
        "counters": {k: v for k, v in snap["counters"].items() if k.startswith(COLD_PREFIXES)},
        "checked": checked,
        "launches": launches,
        "resumed": {"wall_ms": r_wall_ms, "chain_read_obj": reads, "rpc_calls": r_snap["counters"].get("rpc.calls", 0),
                    "launches": r_launches},
        "bundle": os.path.join(root, "cli-range-first.json"),
    }


def _write_json(path: str, obj) -> str:
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


def cli_verify(world, bundle_path: str, root: str, seed: int) -> dict:
    """``verify --check-cids`` on the range's bundle, on the card: exit 0
    with blake2b launched (the witness recompute and the TxMeta batch, held
    against the plain versions); with ``--f3-cert`` a certificate whose EC
    chain is the range's chain, signed by a power table from ``--seed``:
    exit 0; a certificate over other epochs: exit 1; a copy with one
    witness block flipped: the CID recompute raises."""
    _, _, tipsets, _ = world
    backend = get_backend("gpu")
    t0 = time.perf_counter()
    sks, table = seeded_power_table(CLI_SIGNERS, seed)
    (covering,) = finality_certificates(tipsets, sks, table, per_cert=len(tipsets))
    shifted = [dataclasses.replace(ts, height=ts.height + len(tipsets)) for ts in tipsets]
    (elsewhere,) = finality_certificates(shifted, sks, table, per_cert=len(shifted))
    setup_ms = (time.perf_counter() - t0) * 1e3
    cert_path = _write_json(os.path.join(root, "cli-cert-covering.json"), certificate_json_obj(covering))
    other_path = _write_json(os.path.join(root, "cli-cert-elsewhere.json"), certificate_json_obj(elsewhere))
    with open(bundle_path) as fh:
        bundle = json.load(fh)
    block = bundle["blocks"][len(bundle["blocks"]) // 2]
    data = bytearray(base64.b64decode(block["data"]))
    data[len(data) // 2] ^= 0x01
    block["data"] = base64.b64encode(bytes(data)).decode()
    flipped_path = _write_json(os.path.join(root, "cli-flipped.json"), bundle)

    out = {"power_table_rows": len(table), "cert_setup_ms": setup_ms, "ec_chain": len(tipsets)}
    session = _NodeSession(MemoryBlockstore(), [])
    for label, extra, want in (
        ("plain", [], 0),
        ("f3", ["--f3-cert", cert_path], 0),
        ("other epochs", ["--f3-cert", other_path], 1),
    ):
        recording = _RecordingBackend(backend)
        with _cli_node(session, recording):
            stdout, ms, launches, _ = _cli(
                f"cli verify ({label})", ["verify", bundle_path, "--check-cids", "--backend", "gpu", *extra], want
            )
        verdict = json.loads(stdout.strip().splitlines()[-1])
        if verdict["all_valid"] != (want == 0):
            raise AssertionError(f"cli verify ({label}): {verdict['all_valid']}")
        _require_launched(f"cli verify ({label})", launches, SIZE_CLASSES)
        checked = _check_recorded(f"cli verify ({label})", recording, {})
        out[label] = {"wall_ms": ms, "verify_s": verdict["verify_seconds"], "launches": launches,
                      "checked": checked, "false": sum(not v for v in verdict["event_results"] + verdict["storage_results"])}
    with _cli_node(session, _RecordingBackend(backend)):
        try:
            _cli("cli verify (flipped)", ["verify", flipped_path, "--check-cids", "--backend", "gpu"], 1)
        except ValueError as exc:
            if "CID" not in str(exc):
                raise
            out["flipped"] = str(exc)
        else:
            raise AssertionError("cli verify (flipped): a flipped witness block was accepted")
    out["launches"] = out["plain"]["launches"]
    return out


def cli_cert(world, root: str, seed: int) -> dict:
    """``cert --power-table --verify-signatures`` over a chain of
    synthetic certificates (each finalizing the next 64 tipsets, all
    signers, one hash-to-G2 for each: the aggregate signature is the
    signature of the secret keys' sum): every certificate validates; a
    copy of the last with a forged signature fails; ``--emit-cbor`` writes
    certexchange CBOR that validates again."""
    _, _, tipsets, _ = world
    sks, table = seeded_power_table(CLI_SIGNERS, seed)
    span = min(CLI_CERT_SPAN, (len(tipsets) - 1) // CLI_CERTS)
    certs = finality_certificates(tipsets[: CLI_CERTS * span + 1], sks, table, per_cert=span)
    if len(certs) != CLI_CERTS:
        raise AssertionError(f"cli cert: {len(certs)} certificates, expected {CLI_CERTS}")
    paths = [_write_json(os.path.join(root, f"cli-cert-{c.instance}.json"), certificate_json_obj(c)) for c in certs]
    table_path = _write_json(os.path.join(root, "cli-power-table.json"), power_table_json(table))
    forged = certificate_json_obj(certs[-1])
    forged["Signature"] = certificate_json_obj(certs[0])["Signature"]
    forged_path = _write_json(os.path.join(root, "cli-cert-forged.json"), forged)
    cbor_path = os.path.join(root, "cli-cert-0.cbor")

    stdout, ms, launches, _ = _cli("cli cert", ["cert", *paths, "--power-table", table_path, "--verify-signatures"])
    result = json.loads(stdout)
    if result["status"] != "ok" or not result["signatures_verified"] or result["certificates"] != len(certs):
        raise AssertionError(f"cli cert: {result}")
    stdout, forged_ms, _, _ = _cli(
        "cli cert (forged)", ["cert", *paths[:-1], forged_path, "--power-table", table_path, "--verify-signatures"], 1
    )
    if "signature is invalid" not in json.loads(stdout)["error"]:
        raise AssertionError(f"cli cert (forged): {stdout}")
    _cli("cli cert (emit)", ["cert", paths[0], "--emit-cbor", cbor_path])
    stdout, cbor_ms, _, _ = _cli("cli cert (cbor)", ["cert", cbor_path, "--power-table", table_path, "--verify-signatures"])
    if json.loads(stdout)["status"] != "ok":
        raise AssertionError(f"cli cert (cbor): {stdout}")
    return {
        "certificates": len(certs), "power_table_rows": len(table), "tipsets_each": span,
        "wall_ms": ms, "ms_per_certificate": ms / len(certs), "forged_wall_ms": forged_ms,
        "cbor_wall_ms": cbor_ms, "cbor_bytes": os.path.getsize(cbor_path), "launches": launches,
    }


def cli_rest(world, root: str) -> dict:
    """``generate`` (one pair: the topdown nonce slot and the event proofs,
    the slot keccak on the card), ``vectors`` (capture against the hermetic
    node, then ``check_vectors`` on the file) and ``demo``, each exiting 0
    on the card."""
    store, pairs, tipsets, _ = world
    backend = get_backend("gpu")
    out = {}
    height = next(p.parent.height for p in pairs if p.parent.height % 100 == 0)
    bundle_path = os.path.join(root, "cli-generate.json")
    session = _NodeSession(store, tipsets)
    recording = _RecordingBackend(backend)
    with _cli_node(session, recording):
        _, ms, launches, _ = _cli("cli generate", [
            "generate", "--endpoint", CLI_ENDPOINT, "--height", str(height), "--contract", CLI_ETH,
            "--slot-subnet", CLI_SUBNET, "--event-sig", SIGNATURE, "--topic1", CLI_SUBNET,
            "--backend", "gpu", "-o", bundle_path,
        ])
        with open(bundle_path) as fh:
            bundle = UnifiedProofBundle.from_json(fh.read())
        if len(bundle.storage_proofs) != 1 or not bundle.event_proofs:
            raise AssertionError(f"cli generate: {len(bundle.storage_proofs)} storage, {len(bundle.event_proofs)} event proofs")
        _require_launched("cli generate", launches, ["keccak256_single_block"])
        out["generate"] = {"height": height, "wall_ms": ms, "event_proofs": len(bundle.event_proofs),
                           "launches": launches, "checked": _check_recorded("cli generate", recording, {})}
        vectors_path = os.path.join(root, "cli-vectors.json")
        _, ms, _, _ = _cli("cli vectors", ["vectors", "--endpoint", CLI_ENDPOINT, "--height", str(height),
                                           "-o", vectors_path])
        out["vectors"] = {"wall_ms": ms, "checked": check_vectors(load_vectors(vectors_path))}
    recording = _RecordingBackend(backend)
    with _cli_node(session, recording):
        stdout, ms, launches, _ = _cli("cli demo", ["demo"])
    if "All valid: True" not in stdout:
        raise AssertionError(f"cli demo: {stdout}")
    _require_launched("cli demo", launches, ["blake2b256_single_block", "keccak256_single_block"])
    out["demo"] = {"wall_ms": ms, "launches": launches, "checked": _check_recorded("cli demo", recording, {})}
    return out


# --- slice 7: the device mesh and the batch match pipeline ------------------------

MATCH_WORLD = (4096, 16, 4)  # bench.py's kernel leg world: T, R, E (262,144 events)
# the match kernels' edge worlds (T, R, E): E = 1, 3 and 33 with receipts
# not a multiple of a block's, one receipt of 300 events, no tipsets
MATCH_EDGES = ((3, 77, 1), (5, 41, 3), (2, 9, 33), (1, 1, 300), (0, 4, 4))
CID_MESSAGES = 1 << 20  # BASELINE config 4: 1,048,576 nodes of 200 B
CID_NODE_BYTES = 200
MESH_CLI_PAIRS = 512  # the CLI's mesh run: a prefix of the chained world


SECTOR_BYTES = 32  # the least a load moves between HBM and the L2


def _sector_bytes(need: np.ndarray, itemsize: int, sector: int = SECTOR_BYTES) -> int:
    """Bytes of the ``sector``-byte sectors of an array of ``itemsize``-byte
    elements, one an event, that hold an element of an event where
    ``need`` is set."""
    need = np.asarray(need, dtype=bool).reshape(-1)
    if itemsize >= sector:
        return int(need.sum()) * itemsize
    per = sector // itemsize
    return int(np.pad(need, (0, (-need.size) % per)).reshape(-1, per).any(axis=1).sum()) * sector


def _least_bytes(columns, written: int, sector: int = SECTOR_BYTES) -> int:
    """The bytes a match function must move on these inputs: ``written``
    output bytes, and the fewest input bytes that an evaluation stopping
    at an event's first failed test reads. ``columns`` lists each input's
    (bytes an event, where its test passes); an input is read, in
    ``sector``-byte sectors, only for the events whose inputs read before
    it all passed, in the order of the inputs that reads least. An input
    with no test of its own (a receipt id) passes everywhere."""
    least = None
    for order in itertools.permutations(columns):
        alive = np.ones(len(columns[0][1]), dtype=bool)
        total = 0
        for itemsize, passes in order:
            total += _sector_bytes(alive, itemsize, sector)
            alive = alive & np.asarray(passes, dtype=bool).reshape(-1)
        least = total if least is None else min(least, total)
    return least + written


def _topic_columns(batch: EventBatch, t0: bytes, t1: bytes) -> list:
    """`_least_bytes` columns of the full-word mask: each topic's 32 B
    (equal to its spec), n_topics (at least 2) and valid."""
    topics = batch.topics.reshape(-1, 2, 8)
    return [
        (32, (topics[:, 0] == np.frombuffer(t0, "<u4")).all(axis=-1)),
        (32, (topics[:, 1] == np.frombuffer(t1, "<u4")).all(axis=-1)),
        (4, batch.n_topics.reshape(-1) >= 2),
        (1, batch.valid.reshape(-1)),
    ]


def _match_bytes(batch: EventBatch, t0: bytes, t1: bytes, actor: int, sector: int = SECTOR_BYTES) -> int:
    """What `match_pipeline` must move on the batch (`_least_bytes`): the
    full-word mask's inputs and the emitter (4 B, equal to the actor), the
    mask 1 B an event, the hits 1 B a receipt and the count; in 32-B
    sectors (each topic a column of its own), or recounted in the 64-B
    bursts HBM3 moves (an event's topic row one column: a read of topic0
    brings the whole row)."""
    t, r, e = batch.shape
    columns = _topic_columns(batch, t0, t1)
    if sector == 64:
        columns = [(64, columns[0][1] & columns[1][1])] + columns[2:]
    columns += [(4, batch.emitters.reshape(-1) == actor)]
    return _least_bytes(columns, t * r * e + t * r + 4, sector)


def _pass_body(fn):
    """A `measure_pass_seconds` body for a match function over seven
    arguments: ``i`` is XORed into topic0's 8 spec words (not into the
    16.8 MB of topics, which in eager PyTorch would be a pass of its own),
    and the pass returns the count."""

    def body(i, topics, n_topics, emitters, valid, topic0, topic1, actor_id):
        return fn(topics, n_topics, emitters, valid, topic0 ^ i, topic1, actor_id)[2]

    return body


def _sharded_body(fn):
    """`_pass_body` for a sharded function: ``i`` into every replica of
    topic0's spec words."""

    def body(i, topics, n_topics, emitters, valid, topic0, topic1, actor_id):
        spec = tuple(t ^ i.to(t.device) for t in topic0)
        return fn(topics, n_topics, emitters, valid, spec, topic1, actor_id)[2]

    return body


def _same_match(label: str, got, want) -> None:
    hits, mask, count = (x.cpu() for x in got)
    if not (torch.equal(hits, want[0]) and torch.equal(mask, want[1]) and int(count) == int(want[2])):
        raise AssertionError(f"{label}: differs from the plain run on the CPU")


def _edge_world(shape, seed: int):
    """A small match world with every predicate exercised: planted matches,
    near misses (one topic word flipped), ``n_topics`` below 2, invalid
    rows and another emitter."""
    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    batch = synthetic_event_batch(*shape, t0, t1, emitter=ACTOR_ID, match_rate=0.6, seed=seed)
    rng = np.random.default_rng(seed)
    batch.valid[rng.random(shape) < 0.1] = False
    batch.n_topics[rng.random(shape) < 0.1] = 1
    batch.emitters[rng.random(shape) < 0.15] = ACTOR_ID + 1
    near = rng.random(shape) < 0.1
    batch.topics[near, 0] = np.frombuffer(t0, "<u4")
    batch.topics[near, 1] = np.frombuffer(t1, "<u4")
    batch.topics[near, 1, 3] ^= 1
    return batch


def _flat_args(batch: EventBatch, device):
    """`match.topic_mask`'s five tensors for the batch's events as flat rows."""
    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    return (
        _to(batch.topics.reshape(-1, 2, 8), device),
        _to(batch.n_topics.reshape(-1), device),
        torch.from_numpy(np.ascontiguousarray(batch.valid.reshape(-1))).to(device),
        _to(np.frombuffer(t0, "<u4"), device),
        _to(np.frombuffer(t1, "<u4"), device),
    )


def _kernel_err(label: str, device, kernel, plain, args) -> int:
    """The kernel and its plain version on the same inputs on the card, and
    the plain version on a CPU copy: every output equal (max abs err 0)."""
    got, want = kernel(*args), plain(*args)
    on_cpu = plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    got, want, on_cpu = (x if isinstance(x, tuple) else (x,) for x in (got, want, on_cpu))
    err = max(_max_abs_err(g, w) for g, w in zip(got, want))
    if err or not all(g.dtype == w.dtype and torch.equal(g.cpu(), c) for g, w, c in zip(got, want, on_cpu)):
        raise AssertionError(f"{label}: the kernel differs from its plain version (max abs err {err})")
    if any(g.dtype == torch.bool and g.numel() and int(g.view(torch.uint8).max()) > 1 for g in got):
        raise AssertionError(f"{label}: a bool output holds a byte other than 0 or 1")
    return err


def _match_edges(device) -> "list[str]":
    """Each match kernel against its plain version at the edge shapes:
    E = 1, 3 and 33 (receipts not a multiple of a block's), one receipt
    of 300 events, an empty world, the actor filter off (-1) and on, flat
    rows not a multiple of the block and none, receipt ids over
    [-2·num, 2·num) in both widths."""
    cases = []
    for k, shape in enumerate(MATCH_EDGES):
        batch = _edge_world(shape, seed=k)
        t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
        for actor in (None, ACTOR_ID):
            args = batch_args(batch, t0, t1, actor, device)
            _kernel_err(f"match_pipeline {shape} actor {actor}", device, match_pipeline, match_pipeline_plain, args)
        flat = _flat_args(batch, device)
        n = flat[0].shape[0]
        _kernel_err(f"event_match_mask {n} rows", device, match.topic_mask, match.topic_mask_plain, flat)
        rng = np.random.default_rng(k)
        fp = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64))
        fp[::3] = -7
        _kernel_err(f"event_match_mask_fp {n} rows", device, match.fp_mask, match.fp_mask_plain,
                    (fp.to(device), flat[2], -7))
        if n > 1:  # f[1:]: an int64 view that is 8-byte aligned only
            _kernel_err(f"event_match_mask_fp {n - 1} rows, offset view", device, match.fp_mask,
                        match.fp_mask_plain, (fp.to(device)[1:], flat[2][1:], -7))
        num = max(1, n // 3)
        for dtype in (torch.int32, torch.int64):
            ids = torch.from_numpy(rng.integers(-2 * num, 2 * num, n)).to(dtype).to(device)
            _kernel_err(f"receipts_with_match {n} rows, {num} receipts, {dtype}", device,
                        match.receipts_with_match, match.receipts_with_match_plain, (flat[2], ids, num))
        cases.append(f"{shape}")
    return cases


# the two flat masks beside the full-word mask with streaming loads and a
# store-only kernel (``csrc/match_study.cu``)

MATCH_STUDY = "match_study"  # built and launched by this script only, never by the package
# rows of a flat mask call: phase 3a's world, an overlapped-unfused call
# (the event path's 262,144 events in four), a cold-read call (16,384 in
# eight)
MASK_ROWS = (262_144, 65_536, 2_048)
TOPIC0_SHARES = (0.0, 0.01, 0.10, 0.50, 1.0)  # events whose topic0 equals the spec, swept
# the C entries this script launches straight through `ops.build.launch`:
# the package's two flat masks and the study's kernels
_RAW_ARGTYPES = {
    "event_match_mask": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    "event_match_mask_streaming": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    "event_match_mask_fp": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2,
    "store_floor": [ctypes.c_longlong] + [ctypes.c_void_p] * 2,
}
_raw_launches: "collections.Counter[str]" = collections.Counter()  # apart from the package's counts


def _raw_mask(library: str, name: str, args: list, n: int, device) -> torch.Tensor:
    mask = torch.empty(n, dtype=torch.bool, device=device)
    if n:
        launch(library, name, _RAW_ARGTYPES[name], args, [mask], device, _raw_launches)
    return mask


def raw_topic_mask(library: str, name: str):
    """`match.topic_mask`'s signature over the C entry ``name`` of
    ``csrc/<library>.cu``, launched without the wrapper's checks, so that
    two designs are timed through the same host path."""
    def call(topics, n_topics, valid, topic0, topic1):
        n = topics.shape[0]
        args = [t.data_ptr() for t in (topics, n_topics, valid, topic0, topic1)] + [n]
        return _raw_mask(library, name, args, n, topics.device)

    return call


def raw_fp_mask(f, valid, target):
    """`match.fp_mask` launched as `raw_topic_mask` launches a full-word mask."""
    return _raw_mask("match", "event_match_mask_fp", [f.data_ptr(), valid.data_ptr(), f.shape[0], target],
                     f.shape[0], f.device)


def store_floor(first, *_):
    """A kernel that stores one zero mask byte a thread and loads nothing,
    at a flat mask's grid over ``first``'s rows: the launch floor."""
    return _raw_mask(MATCH_STUDY, "store_floor", [first.shape[0]], first.shape[0], first.device)


def topic0_share(topics: np.ndarray, t0: bytes, share: float, seed: int) -> np.ndarray:
    """Flat topic rows ``topics`` [N, 2, 8] (u32) with topic0 equal to the
    spec on round(share * N) rows: the rows where it already is (the
    world's full matches) stay, down to that count; rows added to reach it
    keep their topic1, which is not the spec's."""
    topics = topics.copy()
    spec0 = np.frombuffer(t0, "<u4")
    hit = np.flatnonzero((topics[:, 0] == spec0).all(axis=-1))
    want = round(share * len(topics))
    rng = np.random.default_rng(seed)
    if want < hit.size:
        topics[rng.choice(hit, hit.size - want, replace=False), 0, 0] ^= 1
    else:
        miss = np.setdiff1d(np.arange(len(topics)), hit)
        topics[rng.choice(miss, want - hit.size, replace=False), 0] = spec0
    return topics


def _flat_topic_columns(topics, n_topics, valid, t0: bytes, t1: bytes, row_bytes: int) -> list:
    """`_least_bytes` columns of the full-word mask over flat rows: at
    ``row_bytes`` 32 each topic is a column of its own, read in 32-B
    sectors; at 64 the row is one column (a read of topic0 brings the
    whole 64-B row)."""
    eq0 = (topics[:, 0] == np.frombuffer(t0, "<u4")).all(axis=-1)
    eq1 = (topics[:, 1] == np.frombuffer(t1, "<u4")).all(axis=-1)
    rows = [(32, eq0), (32, eq1)] if row_bytes == 32 else [(64, eq0 & eq1)]
    return rows + [(4, n_topics >= 2), (1, valid)]


def _topic_bounds(topics, n_topics, valid, t0: bytes, t1: bytes) -> dict:
    """The full-word mask's byte bound on these rows, in 32-B sectors and
    recounted in 64-B ones: bytes and ms."""
    n = len(topics)
    out = {}
    for sector in (32, 64):
        moved = _least_bytes(_flat_topic_columns(topics, n_topics, valid, t0, t1, sector), n, sector)
        out[f"bytes_{sector}"], out[f"bound_ms_{sector}"] = moved, moved / HBM_BYTES_PER_S * 1e3
    return out


def _device_us_each(cases: dict, reps: int = 20) -> dict:
    """Device µs a call of each case's kernel from one torch.profiler
    session: ``cases`` maps a label to (fn, copies, kernel name, or a
    tuple of names: a kernel and the memset before it); the
    cases' calls take turns, each case rotating over its own copies
    (`_copies`), so no case runs first or last in the session; a case's
    device time is that of the profiler rows whose key holds one of its
    names; a row that several cases' names match (the memset before each
    of several designs' kernels) is split equally among them. None where
    the profiler saw none (then not measured)."""
    turns = {label: itertools.cycle(copies) for label, (_, copies, _) in cases.items()}
    calls = max([reps] + [len(copies) for _, copies, _ in cases.values()])
    for label, (fn, _, _) in cases.items():
        for _ in range(3):
            fn(*next(turns[label]))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for label, (fn, _, _) in cases.items():
                fn(*next(turns[label]))
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def matches(names, key):
        names = (names,) if isinstance(names, str) else names
        return any(name.replace(" ", "") in key.replace(" ", "") for name in names)

    shares = [(key, t, sum(matches(names, key) for _, _, names in cases.values())) for key, t in rows]
    out = {}
    for label, (_, _, names) in cases.items():
        us = [t / n for key, t, n in shares if matches(names, key)]
        out[label] = sum(us) / calls if us and sum(us) > 0 else None
    return out


def _timed_rows(cases: dict, max_copies: "int | None" = None, after_copy: bool = True) -> dict:
    """Each case (label: (fn, args, kernel name)) timed cold and warm by
    CUDA events (`_cold_cuda_ms`, `_cuda_ms`), and on the device in two
    `_device_us_each` sessions for all cases: over clones of its inputs of
    its own (cold; at most ``max_copies`` of them, where inputs of a few
    kilobytes would otherwise take tens of thousands), and right after
    each call's tensor inputs were copied from host memory, as the
    wrappers copy them (after a copy; not without ``after_copy``): ms each."""
    copies = {label: _copies(args)[1:][:max_copies] for label, (_, args, _) in cases.items()}
    device_us = _device_us_each({label: (fn, copies[label], name) for label, (fn, _, name) in cases.items()})

    def copied(fn, device):
        return lambda *host: fn(*(a.to(device) if isinstance(a, torch.Tensor) else a for a in host))

    def on_host(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)

    copied_us = _device_us_each({label: (copied(fn, args[0].device), [on_host(args)], name)
                                 for label, (fn, args, name) in cases.items()}) if after_copy else {}
    out = {}
    for label, (fn, args, _) in cases.items():
        us, copied_at = device_us[label], copied_us.get(label)
        out[label] = {
            "ms": _cold_cuda_ms(fn, copies[label]),
            "warm_ms": _cuda_ms(lambda fn=fn, args=args: fn(*args), reps=20),
            "device_ms": us / 1e3 if us is not None else None,
            "after_copy_device_ms": copied_at / 1e3 if copied_at is not None else None,
        }
    return out


def _floor_ms(rows: int, device) -> "float | None":
    """`store_floor`'s device ms at ``rows``."""
    us = _device_us_each({"floor": (store_floor, [(torch.empty(rows, dtype=torch.bool, device=device),)],
                                    "store_floor_kernel")})["floor"]
    return us / 1e3 if us is not None else None


def _host_step(fn, sync: bool = True) -> "tuple[object, float]":
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def whole_call_split(kind: str, rows: tuple, t0: bytes, t1: bytes, device, reps: int = 10) -> dict:
    """One whole call of a flat mask on host arrays (``kind`` "flat":
    `GpuBackend.event_match_mask_flat`; "fp": `event_match_mask_fp`) and
    the same call taken apart as the wrapper runs it: the host numpy work,
    each host-to-card copy, the launch and the copy back, each ended by a
    synchronize; median ms of ``reps`` calls each."""
    backend = get_backend("gpu")
    steps: "dict[str, list[float]]" = collections.defaultdict(list)
    for _ in range(reps):
        if kind == "flat":
            _, ms = _host_step(lambda: backend.event_match_mask_flat(*rows, t0, t1, ACTOR_ID))
            steps["whole"].append(ms)
            topics, n_topics, emitters, valid = rows
            (host, ms) = _host_step(lambda: (
                torch.from_numpy(np.ascontiguousarray(topics).view(np.int32)),
                torch.from_numpy(np.ascontiguousarray(n_topics, dtype=np.int32)),
                torch.from_numpy(np.ascontiguousarray(np.asarray(valid, dtype=bool) & (emitters == ACTOR_ID))),
                torch.from_numpy(np.frombuffer(t0, dtype="<i4").copy()),
                torch.from_numpy(np.frombuffer(t1, dtype="<i4").copy()),
            ), sync=False)
            steps["host"].append(ms)
            names = ("topics", "n_topics", "valid", "topic0", "topic1")
            kernel = match.topic_mask
        else:
            _, ms = _host_step(lambda: backend.event_match_mask_fp(*rows, t0, t1, ACTOR_ID))
            steps["whole"].append(ms)
            fp, n_topics, emitters, valid = rows
            (host, ms) = _host_step(lambda: (
                torch.from_numpy(np.array(fp, dtype="<u8").view(np.int64)),
                torch.from_numpy(np.asarray(valid, dtype=bool) & (np.asarray(n_topics) >= 2) & (emitters == ACTOR_ID)),
            ), sync=False)
            steps["host"].append(ms)
            names = ("fp", "valid")
            target = int.from_bytes(topic_fingerprint(t0, t1).to_bytes(8, "little"), "little", signed=True)
            kernel = lambda f, ok: match.fp_mask(f, ok, target)  # noqa: E731
        on_card = []
        for name, tensor in zip(names, host):
            moved, ms = _host_step(lambda tensor=tensor: tensor.to(device))
            on_card.append(moved)
            steps[f"copy {name}"].append(ms)
        mask, ms = _host_step(lambda: kernel(*on_card))
        steps["launch"].append(ms)
        _, ms = _host_step(lambda: mask.cpu().numpy(), sync=False)
        steps["copy back"].append(ms)
    out = {step: float(np.median(values)) for step, values in steps.items()}
    out["sum of steps"] = sum(v for step, v in out.items() if step != "whole")
    return out


def flat_mask_study(batch: EventBatch, fp: np.ndarray, target: int, smi: str, device) -> dict:
    """The two flat masks on phase 3a's events, each launched straight
    through `ops.build.launch` (`raw_topic_mask`, `raw_fp_mask`): the
    full-word mask beside the same mask with streaming loads
    (``csrc/match_study.cu``), and the fingerprint mask, at `MASK_ROWS`
    (cold and warm CUDA events, device time with the calls taking turns,
    cold and right after a copy from the host) with the launch floor (`store_floor`) and the byte bound; both
    full-word masks over `TOPIC0_SHARES` at full width, each share first
    held equal to the plain version through the package's wrapper, with
    the bound in 32-B and 64-B sectors; and each mask's whole call taken
    apart (`whole_call_split`) at the least and the most of `MASK_ROWS`."""
    start = time.perf_counter()
    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    n = batch.topics.size // 16
    flat = _flat_args(batch, device)
    fp_args = (torch.from_numpy(fp.view(np.int64)).to(device), torch.ones(n, dtype=torch.bool, device=device), target)
    topics_np = batch.topics.reshape(-1, 2, 8)
    n_topics_np, valid_np = batch.n_topics.reshape(-1), batch.valid.reshape(-1)
    topic_mask = raw_topic_mask("match", "event_match_mask")
    streaming = raw_topic_mask(MATCH_STUDY, "event_match_mask_streaming")
    _kernel_err(f"event_match_mask, streaming ({n:,} rows)", device, streaming, match.topic_mask_plain, flat)

    by_rows = {}
    for rows in MASK_ROWS:
        part = tuple(a[:rows] for a in flat[:3]) + flat[3:]
        fp_part = (fp_args[0][:rows], fp_args[1][:rows], target)
        timed = _timed_rows({
            "event_match_mask": (topic_mask, part, "topic_mask_kernel"),
            "event_match_mask streaming": (streaming, part, "topic_mask_streaming_kernel"),
            "event_match_mask_fp": (raw_fp_mask, fp_part, "fp_mask_kernel"),
        })
        floor_ms = _floor_ms(rows, device)
        fp_bytes = _least_bytes([(8, fp[:rows].view(np.int64) == target), (1, np.ones(rows, bool))], rows)
        bounds = {
            "event_match_mask": _topic_bounds(topics_np[:rows], n_topics_np[:rows], valid_np[:rows], t0, t1),
            "event_match_mask_fp": {"bytes_32": fp_bytes, "bound_ms_32": fp_bytes / HBM_BYTES_PER_S * 1e3},
        }
        for label, row in timed.items():
            row["floor_ms"] = floor_ms
            row.update(bounds[label.split()[0]])
        by_rows[rows] = timed
        _log(f"flat masks at {rows:,} rows on {smi}: {json.dumps(timed)}")

    # the full-word mask over the share of events whose topic0 matches
    shares = {}
    for share in TOPIC0_SHARES:
        topics = topic0_share(topics_np, t0, share, seed=int(share * 1000))
        args = (_to(topics, device), *flat[1:])
        for label, fn in (("package", match.topic_mask), ("streaming", streaming)):
            _kernel_err(f"event_match_mask ({label}, topic0 on {share:.0%} of rows)", device, fn,
                        match.topic_mask_plain, args)
        timed = _timed_rows({"package": (topic_mask, args, "topic_mask_kernel"),
                             "streaming": (streaming, args, "topic_mask_streaming_kernel")})
        shares[share] = {"topic0_rows": int((topics[:, 0] == np.frombuffer(t0, "<u4")).all(axis=-1).sum()),
                         **timed, **_topic_bounds(topics, n_topics_np, valid_np, t0, t1)}
        _log(f"event_match_mask, topic0 on {share:.0%} of {n:,} rows on {smi}: {json.dumps(shares[share])}")

    flat_rows = (topics_np, n_topics_np, batch.emitters.reshape(-1).astype(np.int64), valid_np)
    fp_rows = (fp, np.full(n, 2, dtype=np.int32), np.full(n, ACTOR_ID, dtype=np.int64), np.ones(n, dtype=bool))
    split = {}
    for rows in (min(MASK_ROWS), max(MASK_ROWS)):
        for kind, arrays in (("flat", flat_rows), ("fp", fp_rows)):
            split[f"{kind} {rows}"] = whole_call_split(kind, tuple(a[:rows] for a in arrays), t0, t1, device)
    _log(f"flat masks' whole calls taken apart on {smi} (median ms of 10): {json.dumps(split)}")
    seconds = time.perf_counter() - start
    _log(f"flat mask study: {seconds:.1f} s")
    return {"by_rows": by_rows, "topic0_shares": shares, "whole_call_split": split, "seconds": seconds}


# match_pipeline's kernel body against other designs (``csrc/match_study.cu``)

# the rule's shapes (T, R, E): phase 3a's world (262,144 events), one block
# of the virtual (2, 2) mesh over it (65,536 events at E = 2), `entry.py`'s
# world (64 events)
PIPELINE_SHAPES = ((4096, 16, 4), (2048, 16, 2), (4, 4, 4))
# design: (library, C entry, the profiler rows of a call (a memset before the
# kernel counts: the count's zeroing), `match_kernel_info`'s index)
_MEMSET = ("Memset",)
PIPELINE_DESIGNS = {
    "package": ("match", "match_pipeline", ("match_pipeline_kernel",) + _MEMSET, 0),
    "PR 16": (MATCH_STUDY, "match_pipeline_memset", ("match_memset_kernel",) + _MEMSET, 1),
    "ticket": (MATCH_STUDY, "match_pipeline_ticket", ("match_ticket_kernel",), 2),
    "persistent": (MATCH_STUDY, "match_pipeline_persistent", ("match_persistent_kernel",) + _MEMSET, 3),
    "tma": (MATCH_STUDY, "match_pipeline_tma", ("match_tma_kernel",) + _MEMSET, 4),
    "pair": (MATCH_STUDY, "match_pipeline_pair", ("match_pair_kernel",) + _MEMSET, 5),
}
PIPELINE_SLOWDOWN_AT_FLOOR = 1.03  # the rule: at 64 events a body may be up to 3 % slower
# clones a design's "cold" calls rotate over: at 64 events (5 KB) they stay
# in the L2 all the same
PIPELINE_COPIES = 32


def raw_pipeline(library: str, name: str):
    """`match_pipeline`'s seven arguments over the C entry ``name`` of
    ``csrc/<library>.cu``, launched into fresh outputs without the
    wrapper's checks, so that every design is timed through the same host
    path."""
    def call(topics, n_topics, emitters, valid, topic0, topic1, actor_id):
        t, r, e = n_topics.shape
        device = topics.device
        out = [torch.empty((t, r), dtype=torch.bool, device=device),
               torch.empty((t, r, e), dtype=torch.bool, device=device),
               torch.empty((), dtype=torch.int32, device=device)]
        args = [x.data_ptr() for x in (topics, n_topics, emitters, valid, topic0, topic1, actor_id)]
        launch(library, name, pipeline._ARGTYPES["match_pipeline"], args + [t * r, e, 0, 0, e, 0], out, device,
               _raw_launches)
        return tuple(out)

    return call


def kernel_info(which: int) -> dict:
    """`match_kernel_info` of ``csrc/match_study.cu``: registers a thread,
    static shared bytes, blocks an SM holds, SMs."""
    from ipc_proofs_tpu_torch.ops.build import load_library

    fn = load_library(MATCH_STUDY).match_kernel_info
    fn.argtypes, fn.restype = [ctypes.c_int] + [ctypes.c_void_p] * 4, ctypes.c_int
    values = [ctypes.c_int(0) for _ in range(4)]
    rc = fn(which, *(ctypes.addressof(v) for v in values))
    if rc:
        raise RuntimeError(f"match_kernel_info({which}): CUDA error {rc}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm", "sms"), (v.value for v in values)))


def _receipts_per_block(e: int, events: int = 256) -> int:
    """``csrc/match.cu`` receipts_per_block (``csrc/match_study.cu``
    pair_receipts_per_block at ``events`` 512)."""
    return events // e if 0 < e < events else (events if e == 0 else 1)


def pipeline_study(batch: EventBatch, smi: str, device) -> dict:
    """`match_pipeline`'s designs (`PIPELINE_DESIGNS`: the package's, PR
    16's, the package's body with the count in the same launch, and the
    persistent, tma and two-events-a-thread bodies) at `PIPELINE_SHAPES`,
    cut from phase 3a's world: each design first held equal to the plain
    version (three calls in a row, so a count or ticket left behind shows)
    here and at the edge worlds, then timed cold and warm by CUDA events
    and on the device with the calls taking turns (`_timed_rows`), beside
    the byte bound in 32-B sectors and in 64-B bursts; each kernel's
    registers, blocks an SM and the waves of its grid; and the rule
    applied: a design wins at a shape where it beats the package's by
    device time and by cold CUDA events (at 64 events it may be up to 3 %
    slower)."""
    start = time.perf_counter()
    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    info = {label: kernel_info(which) for label, (_, _, _, which) in PIPELINE_DESIGNS.items()}
    calls = {label: raw_pipeline(library, name) for label, (library, name, _, _) in PIPELINE_DESIGNS.items()}

    def args_of(part: EventBatch) -> tuple:
        return batch_args(part, t0, t1, ACTOR_ID, device)

    def held(label: str, args: tuple, want: tuple, calls_in_a_row: int) -> None:
        outs = [calls[label](*args) for _ in range(calls_in_a_row)]
        torch.cuda.synchronize()
        for got in outs:
            if not all(g.dtype == w.dtype and torch.equal(g.cpu(), w) for g, w in zip(got, want)) or any(
                    g.dtype == torch.bool and g.numel() and int(g.view(torch.uint8).max()) > 1 for g in got):
                raise AssertionError(f"match_pipeline ({label}) differs from its plain version")

    for k, shape in enumerate(MATCH_EDGES):
        edge = _edge_world(shape, seed=k)
        want = match_pipeline_plain(*batch_args(edge, t0, t1, ACTOR_ID, "cpu"))
        for label in calls:
            held(label, args_of(edge), want, 1)
    by_shape = {}
    for t, r, e in PIPELINE_SHAPES:
        part = EventBatch(topics=batch.topics[:t, :r, :e], n_topics=batch.n_topics[:t, :r, :e],
                          emitters=batch.emitters[:t, :r, :e], valid=batch.valid[:t, :r, :e])
        args = args_of(part)
        want = match_pipeline_plain(*batch_args(part, t0, t1, ACTOR_ID, "cpu"))
        for label in calls:
            held(label, args, want, 3)
        timed = _timed_rows({label: (calls[label], args, names)
                             for label, (_, _, names, _) in PIPELINE_DESIGNS.items()},
                            max_copies=PIPELINE_COPIES, after_copy=False)
        bounds = {f"bound_ms_{sector}": _match_bytes(part, t0, t1, ACTOR_ID, sector) / HBM_BYTES_PER_S * 1e3
                  for sector in (32, 64)}
        for label, row in timed.items():
            tiles = -(-t * r // _receipts_per_block(e, 512 if label.startswith("pair") else 256))
            resident = info[label]["blocks_per_sm"] * info[label]["sms"]
            rounds = -(-tiles // max(resident, 1))
            grid = -(-tiles // rounds) if label in ("persistent", "tma") else tiles
            row.update(bounds, grid=grid, waves=-(-grid // max(resident, 1)))
        package = timed["package"]
        for label, row in timed.items():
            if label != "package" and None not in (row["device_ms"], package["device_ms"]):
                allowed = PIPELINE_SLOWDOWN_AT_FLOOR if t * r * e <= 64 else 1.0
                row["beats_package"] = bool(row["device_ms"] < package["device_ms"] * allowed
                                            and row["ms"] < package["ms"] * allowed)
        by_shape[f"{t * r * e}"] = {"shape": [t, r, e], **timed}
        _log(f"match_pipeline designs at {t * r * e:,} events ({t}, {r}, {e}) on {smi}: {json.dumps(timed)}")
    wins = {label: all(by_shape[key][label].get("beats_package", False) for key in by_shape)
            for label in PIPELINE_DESIGNS if label != "package"}
    seconds = time.perf_counter() - start
    _log(f"match_pipeline kernels on {smi}: {json.dumps(info)}; wins at every shape of the rule "
         f"(device and cold events): {json.dumps(wins)}; {seconds:.1f} s")
    return {"kernels": info, "by_events": by_shape, "wins": wins, "seconds": seconds}


def _ops_a_call(fn, args, calls: int = 20) -> "dict[str, list[float]] | None":
    """The device operations one call of ``fn(*args)`` runs, from
    torch.profiler over ``calls`` calls: each kernel or memset's launches
    and device µs a call, by name; None where the profiler saw none."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    ops = {e.key: [e.count / calls, (getattr(e, "self_device_time_total", 0) or 0) / calls]
           for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")
           and (getattr(e, "self_device_time_total", 0) or 0) > 0}
    return ops or None


def _only_match_ops(ops: "dict[str, list[float]]", blocks: int) -> bool:
    """A call ran match_pipeline's launches (at most ``blocks``), at most
    one memset (its count's) and nothing else. The profiler may miss a
    call's events (0.95 a call seen), so the counts are bounds; the
    launches themselves are the wrappers' counts."""
    kernels = sum(n for key, (n, _) in ops.items() if "match_pipeline_kernel" in key)
    memsets = sum(n for key, (n, _) in ops.items() if "Memset" in key)
    others = [key for key in ops if "match_pipeline_kernel" not in key and "Memset" not in key]
    return 0 < kernels <= blocks and memsets <= 1 and not others


@contextlib.contextmanager
def _no_concatenation():
    """``torch.cat`` and ``torch.stack`` raise inside: a mesh's combine on
    one card must not run them."""
    real = torch.cat, torch.stack

    def refuse(*args, **kwargs):
        raise AssertionError("the match combine ran torch.cat or torch.stack")

    torch.cat = torch.stack = refuse
    try:
        yield
    finally:
        torch.cat, torch.stack = real


def _phase3a_world():
    """Phase 3a's events, and one u64 fingerprint an event (1 % equal to
    the target) with the target as the int64 of its bits."""
    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    batch = synthetic_event_batch(*MATCH_WORLD, t0, t1, emitter=ACTOR_ID, match_rate=0.01, seed=42)
    fp = np.random.default_rng(42).integers(0, 1 << 63, size=batch.topics.size // 16, dtype=np.uint64)
    fp[::100] = np.uint64(topic_fingerprint(t0, t1))
    target = int.from_bytes(topic_fingerprint(t0, t1).to_bytes(8, "little"), "little", signed=True)
    return batch, fp, target


def device_match_phase(device, smi: str) -> dict:
    """The kernel leg's world at full width (``synthetic_event_batch(4096,
    16, 4, match_rate=0.01, seed=42)``: 262,144 events, 16.8 MB of topic
    words) through the four kernels of ``csrc/match.cu``, counts from 0:
    `match_pipeline` on the card, `sharded_match_pipeline` on the real
    mesh ``make_mesh(1)`` and on a virtual (dp=2, sp=2) mesh over
    ``[cuda:0] * 4``, `receipts_with_match` over the flat mask, and the
    same events' full-word and fingerprint masks through the backend
    (single device and the virtual mesh): each equal to the plain run on
    the CPU, each kernel launched as many times as it has blocks, the
    meshes' blocks writing into the mesh's outputs with no ``torch.cat``
    or ``torch.stack`` (`_no_concatenation`). Then
    each kernel against its plain version on the card's inputs, at full
    width and at the edge shapes, and each timed: `match_pipeline` per
    pass by `measure_pass_seconds` (the slope of k replays of the pass
    captured as one CUDA graph, host clock, one sync), with the kernels a
    call runs by the profiler (a mesh's calls may run match_pipeline's
    alone), and every kernel by
    CUDA events over 20 back-to-back calls, beside its plain version, its
    byte bound and, for the receipt reduce, ``mask.view(-1, E).any(-1)``;
    `match_pipeline`'s designs compared (`pipeline_study`)."""
    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    batch, fp, target = _phase3a_world()
    t, r, e = batch.shape
    n = t * r * e
    plain = match_pipeline_plain(*batch_args(batch, t0, t1, ACTOR_ID, "cpu"))
    single_args = batch_args(batch, t0, t1, ACTOR_ID, device)
    meshes = {"mesh of 1": make_mesh(1), "virtual mesh (dp=2, sp=2)": make_mesh(4, sp=2, devices=[device] * 4)}
    sharded = {label: sharded_match_pipeline(mesh) for label, mesh in meshes.items()}
    sharded_args = {label: shard(batch, t0, t1, ACTOR_ID) for label, (_, shard) in sharded.items()}
    ids = torch.arange(t * r, dtype=torch.int32, device=device).repeat_interleave(e)
    # the same events as flat rows (the Python walk's full-word mask), and
    # one u64 fingerprint and a valid bit an event (the unfused scan's mask)
    flat_rows = (batch.topics.reshape(-1, 2, 8), batch.n_topics.reshape(-1),
                 batch.emitters.reshape(-1).astype(np.int64), batch.valid.reshape(-1))
    fp_rows = (fp, np.full(n, 2, dtype=np.int32), np.full(n, ACTOR_ID, dtype=np.int64), np.ones(n, dtype=bool))
    backends = {"single device": get_backend("gpu"),
                "virtual mesh of 4": GpuBackend(device, mesh=meshes["virtual mesh (dp=2, sp=2)"])}
    torch.cuda.synchronize()

    _reset_counts()
    outs = {"single device": match_pipeline(*single_args)}
    with _no_concatenation():  # the blocks write into the mesh's outputs themselves
        for label, (fn, _) in sharded.items():
            outs[label] = fn(*sharded_args[label])
    flat = outs["single device"][1].reshape(-1)
    receipts = match.receipts_with_match(flat, ids, t * r)
    flat_masks = {label: b.event_match_mask_flat(*flat_rows, t0, t1, ACTOR_ID) for label, b in backends.items()}
    fp_masks = {label: b.event_match_mask_fp(*fp_rows, t0, t1, ACTOR_ID) for label, b in backends.items()}
    torch.cuda.synchronize()
    launches = _counts()
    want = {"match_pipeline": 1 + 1 + 4, "receipts_with_match": 1, "event_match_mask": 1,
            "event_match_mask_sharded": 4, "event_match_mask_fp": 1, "event_match_mask_fp_sharded": 4}
    if {name: launches[name] for name in want} != want:
        raise AssertionError(f"device match: launches {launches}, expected {want}")
    for label, out in outs.items():
        _same_match(f"device match ({label})", out, plain)
    if not torch.equal(receipts.cpu(), plain[0].reshape(-1)):
        raise AssertionError("receipts_with_match differs from the plain hits")
    cpu_backend = get_backend("gpu", device="cpu")
    flat_want = cpu_backend.event_match_mask_flat(*flat_rows, t0, t1, ACTOR_ID)
    fp_want = cpu_backend.event_match_mask_fp(*fp_rows, t0, t1, ACTOR_ID)
    for label in backends:
        if not np.array_equal(flat_masks[label], flat_want) or not np.array_equal(flat_want, plain[1].reshape(-1)):
            raise AssertionError(f"full-word mask ({label}) differs from the plain mask")
        if not np.array_equal(fp_masks[label][:n], fp_want) or fp_masks[label][n:].any():
            raise AssertionError(f"fingerprint mask ({label}) differs from the plain mask")

    # each kernel against its plain version on the card's inputs, full width
    flat_args = _flat_args(batch, device)
    fp_args = (torch.from_numpy(fp.view(np.int64)).to(device), torch.from_numpy(fp_rows[3]).to(device), target)
    full = {
        "match_pipeline": (match_pipeline, match_pipeline_plain, single_args),
        "event_match_mask": (match.topic_mask, match.topic_mask_plain, flat_args),
        "event_match_mask_fp": (match.fp_mask, match.fp_mask_plain, fp_args),
        "receipts_with_match": (match.receipts_with_match, match.receipts_with_match_plain, (flat, ids, t * r)),
    }
    errs = {name: _kernel_err(f"{name} ({n:,} events)", device, *case) for name, case in full.items()}
    edges = _match_edges(device)

    # each bound counts the bytes these inputs need (`_least_bytes`): of
    # 262,144 events ~1 % match, so past the first test only those events'
    # sectors count, and the receipt reduce reads an id only under a set
    # mask byte
    mask_np = plain[1].numpy().reshape(-1)
    moved = {
        "match_pipeline": _match_bytes(batch, t0, t1, ACTOR_ID),
        "event_match_mask": _least_bytes(_topic_columns(batch, t0, t1), n),
        "event_match_mask_fp": _least_bytes([(8, fp.view(np.int64) == target), (1, fp_rows[3])], n),
        "receipts_with_match": _least_bytes([(1, mask_np), (ids.element_size(), np.ones(n, dtype=bool))], t * r),
    }
    bound_ms = {name: nbytes / HBM_BYTES_PER_S * 1e3 for name, nbytes in moved.items()}
    _log(f"device match: bytes these inputs need {json.dumps(moved)}")
    timings = {}
    for label, fn, args, body in (
        ("single device", match_pipeline, single_args, _pass_body(match_pipeline)),
        *((label, fn, sharded_args[label], _sharded_body(fn)) for label, (fn, _) in sharded.items()),
    ):
        pt = measure_pass_seconds(body, args)
        if not pt.graph:
            raise AssertionError(f"device match ({label}): the slope did not replay a CUDA graph")
        ms = _cuda_ms(lambda: fn(*args), reps=20)
        timings[label] = {
            "pass_us": pt.seconds * 1e6, "k": [pt.k_small, pt.k_large],
            "events_per_s": n / pt.seconds, "ms": ms, "bound_ms": bound_ms["match_pipeline"],
        }
        _log(f"device match ({label}) on {smi}: {pt.seconds * 1e6:.1f} us/pass (slope k={pt.k_small}/"
             f"{pt.k_large}, graph replays), {n / pt.seconds:,.0f} events/s; CUDA events {ms * 1e3:.1f} us a call; "
             f"bound {bound_ms['match_pipeline'] * 1e3:.2f} us (bytes)")
        # what a call runs on the card (profiler): a mesh on one card runs
        # its blocks' match_pipeline launches and its count's one memset
        ran = _ops_a_call(fn, args)
        timings[label]["device_ops_a_call"] = ran
        _log(f"device match ({label}) on {smi}: a call's device ops (profiler: launches, us) {json.dumps(ran)}")
        blocks = len(args[0]) if label != "single device" else 1
        if ran is not None and not _only_match_ops(ran, blocks):
            raise AssertionError(f"device match ({label}): a call ran other device work than {blocks} match_pipeline "
                                 f"launches and one memset: {ran}")
    # the inputs (1.3-19.4 MB) fit in the 50 MB L2: the row's times are
    # taken cold (calls rotating over copies of the inputs), the warm ones
    # (one copy, read from the L2) logged beside
    # the device time of a call's kernels (and memset) from the profiler
    # beside it: CUDA events over back-to-back calls also hold the gaps
    # between launches
    library = {"receipts_with_match": lambda mask, ids, num: mask.view(-1, e).any(-1)}
    kernels = {}
    for name, (kernel, plain_fn, args) in full.items():
        copies = _copies(args)
        lib = library.get(name)
        device_us = _device_us(kernel, copies)
        library_us = _device_us(lib, copies) if lib else None
        kernels[name] = {
            "rows": n, "max_abs_err": errs[name],
            "ms": _cold_cuda_ms(kernel, copies),
            "plain_ms": _cold_cuda_ms(plain_fn, copies),
            "bound_ms": bound_ms[name], "bound_by": "bytes",
            "library_ms": _cold_cuda_ms(lib, copies) if lib else None,
            "warm_ms": _cuda_ms(lambda: kernel(*args), reps=20),
            "warm_library_ms": _cuda_ms(lambda: lib(*args), reps=20) if lib else None,
            "device_ms": sum(device_us.values()) / 1e3 if device_us else None,
            "library_device_ms": sum(library_us.values()) / 1e3 if library_us else None,
        }
        k = kernels[name]
        _log(f"{name} on {smi}: kernel {k['ms'] * 1e3:.2f} us cold, {k['warm_ms'] * 1e3:.2f} us warm (CUDA events "
             f"a call), device {json.dumps(device_us)} us a call (profiler, cold); plain "
             f"{k['plain_ms'] * 1e3:.2f} us; bound {k['bound_ms'] * 1e3:.3f} us (bytes)"
             + (f"; one PyTorch call {k['library_ms'] * 1e3:.2f} us cold, {k['warm_library_ms'] * 1e3:.2f} us warm, "
                f"device {json.dumps(library_us)} us a call" if lib else ""))
    fp_calls = {}
    for label, backend in backends.items():
        start = time.perf_counter()
        for _ in range(10):
            backend.event_match_mask_fp(*fp_rows, t0, t1, ACTOR_ID)
        fp_calls[label] = (time.perf_counter() - start) * 1e2  # ms a call, copies included
    _log(f"fingerprint mask on {smi}: a whole call with its copies {json.dumps(fp_calls)} ms")
    designs = pipeline_study(batch, smi, device)
    kernels["match_pipeline"]["bound_ms_64"] = _match_bytes(batch, t0, t1, ACTOR_ID, 64) / HBM_BYTES_PER_S * 1e3
    kernels["match_pipeline"]["designs"] = designs
    kernels["match_pipeline"]["passes"] = {label: row["pass_us"] for label, row in timings.items()}
    study = flat_mask_study(batch, fp, target, smi, device)
    full_width = study["by_rows"][n]
    for name in ("event_match_mask", "event_match_mask_fp"):
        kernels[name]["floor_ms"] = full_width[name]["floor_ms"]
    kernels["event_match_mask"]["streaming"] = full_width["event_match_mask streaming"]
    return {
        "events": n, "topic_bytes": batch.topics.nbytes, "matches": int(plain[2]),
        "timings": timings, "kernels": kernels, "edge_worlds": edges,
        "fp_mask_call_ms": fp_calls, "flat_mask_study": study, "launches": launches,
    }


def cid_bench_phase(seed: int, smi: str) -> dict:
    """BASELINE config 4: `blake2b_cid_bench_setup` over 1,048,576 nodes of
    200 B from the seed (the two-block kernel); every first digest equal to
    hashlib; CIDs/s from `measure_pass_seconds` (each pass XORs ``i`` into
    the first plane, then hashes), and the kernel alone by CUDA events
    beside its bound (two compressions a node, as the kernel phase counts
    them)."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, size=(CID_MESSAGES, CID_NODE_BYTES), dtype=np.uint8)
    messages = [row.tobytes() for row in payload]
    _reset_counts()
    one_pass, args, first, name = blake2b_cid_bench_setup(messages)
    torch.cuda.synchronize()
    launches = _counts()
    if name != "blake2b256_two_block" or launches[name] != 1:
        raise AssertionError(f"cid bench: kernel {name}, launches {launches}")
    digests = first.astype("<u4").tobytes()
    for i, message in enumerate(messages):
        if digests[32 * i : 32 * i + 32] != _blake2b(message):
            raise AssertionError(f"cid bench: digest {i} differs from hashlib")
    pt = measure_pass_seconds(one_pass, args, k_small=3, k_large=23)
    if not pt.graph:
        raise AssertionError("cid bench: the slope did not replay a CUDA graph")
    kernel = getattr(blake2b, name)
    kernel_ms = _cuda_ms(lambda: kernel(*args), reps=20)
    rate = CID_MESSAGES / pt.seconds
    bytes_ms = CID_MESSAGES * (256 + 4 + 32) / HBM_BYTES_PER_S * 1e3
    ops_ms = _ops_ms(BLAKE2B_OPS, 2 * CID_MESSAGES)
    _log(f"cid bench on {smi}: {name}, {rate:,.0f} CIDs/s (slope k={pt.k_small}/{pt.k_large}, "
         f"{pt.seconds * 1e3:.4f} ms a pass with the XOR); kernel alone {kernel_ms:.4f} ms, "
         f"{CID_MESSAGES / kernel_ms * 1e3:,.0f} CIDs/s, bound {max(bytes_ms, ops_ms):.4f} ms")
    return {"messages": CID_MESSAGES, "kernel": name, "pass_ms": pt.seconds * 1e3, "k": [pt.k_small, pt.k_large],
            "cids_per_s": rate, "kernel_ms": kernel_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "launches": launches}


def _mesh_generate(label, store, pairs, backend, specs, expected, plain_cache):
    """One serial range run with a mesh backend, counts from 0: its bytes
    equal to the single-device bundle's, the sharded mask launched, and
    every recorded kernel call and mask equal to the plain versions."""
    recording = _RecordingBackend(backend)
    gc.collect()
    _reset_counts()
    t0 = time.perf_counter()
    bundle = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID), match_backend=recording, storage_specs=specs
    )
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    if bundle.to_json() != expected:
        raise AssertionError(f"{label}: the bundle differs from the single-device bundle")
    _require_launched(label, launches, ["event_match_mask_fp_sharded", "keccak256_single_block"])
    checked = _check_recorded(label, recording, plain_cache)
    return {"wall_ms": wall_ms, "proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
            "launches": launches, "checked": checked}


def mesh_range(world, device) -> dict:
    """The event path's world with the topdown nonce slot at every pair,
    through `generate_event_proofs_for_range` with ``get_backend("gpu",
    mesh_devices=1)`` and with a virtual 4-device mesh on the card: the
    single-device bundle's bytes; then `generate_and_verify_range_overlapped`
    over the virtual mesh at the host's budget: the same bytes, every
    verdict true, the coalescer's ``range_match_coalesced`` and the sharded
    mask's launches non-zero, every recorded mask (its filler rows False)
    and hash equal to the plain versions; last
    `dryrun_multichip` over the real cards and over ``[cuda:0] * 4``."""
    store, pairs, n_matching = world
    specs = [MappingSlotSpec(ACTOR_ID, TOPIC1, 0)]
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    single = get_backend("gpu")
    expected = generate_event_proofs_for_range(store, pairs, spec, match_backend=single, storage_specs=specs).to_json()
    virtual = GpuBackend(device, mesh=make_mesh(4, sp=2, devices=[device] * 4))
    plain_cache: dict = {}
    out = {
        "mesh of 1": _mesh_generate("mesh range (mesh of 1)", store, pairs, get_backend("gpu", mesh_devices=1),
                                    specs, expected, plain_cache),
        "virtual mesh of 4": _mesh_generate("mesh range (virtual mesh of 4)", store, pairs, virtual, specs,
                                            expected, plain_cache),
    }
    budget = resolve_thread_budget()
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    recording = _RecordingBackend(virtual)
    gc.collect()
    metrics = Metrics()
    _reset_counts()
    t0 = time.perf_counter()
    merged, verdicts = generate_and_verify_range_overlapped(
        store, pairs, spec, chunk_size=chunk_size, match_backend=recording, metrics=metrics,
        storage_specs=specs, threads=budget.total, scan_threads=budget.scan_workers,
        verify_chunk=lambda b: verify_proof_bundle(
            b, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=recording
        ).event_results,
    )
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    if merged.to_json() != expected:
        raise AssertionError("mesh range (overlapped): the bundle differs from the single-device bundle")
    flat = [v for chunk in verdicts for v in chunk]
    if len(flat) != n_matching or not all(flat):
        raise AssertionError("mesh range (overlapped): a verdict is false")
    counters = {"range_match_coalesced": metrics.counter_value("range_match_coalesced")}
    if not all(counters.values()) or not launches["event_match_mask_fp_sharded"]:
        raise AssertionError(f"mesh range (overlapped): counters {counters}, launches {launches}")
    checked = _check_recorded("mesh range (overlapped)", recording, plain_cache)
    out["overlapped"] = {"wall_ms": wall_ms, "proofs_per_s": len(merged.event_proofs) / wall_ms * 1e3,
                         "chunk_size": chunk_size, "counters": counters, "launches": launches, "checked": checked}
    out["dryrun_multichip"] = {
        "cards": dryrun_multichip(torch.cuda.device_count()),
        "virtual": dryrun_multichip(4, devices=[device] * 4),
    }
    out.update(pairs=len(pairs), proofs=n_matching, storage_proofs=len(pairs),
               launches=out["virtual mesh of 4"]["launches"])
    return out


def multihost_phase(device) -> dict:
    """A one-rank NCCL group on the card (a TCP store on localhost): the
    sharded match over `global_mesh(sp=2)` on ``[cuda:0] * 4`` with the
    count all-reduced and the hits all-gathered through NCCL, equal to the
    single-device run."""
    import torch.distributed as dist

    t0, t1 = hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)
    batch = synthetic_event_batch(512, 16, 4, t0, t1, emitter=ACTOR_ID, match_rate=0.01, seed=42)
    want = match_pipeline(*batch_args(batch, t0, t1, ACTOR_ID, device))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=device):
        raise AssertionError("multihost: no process group")
    try:
        backend = dist.get_backend()
        mesh = global_mesh(sp=2, devices=[device] * 4)
        if not mesh.distributed or mesh.shape != {"dp": 2, "sp": 2}:
            raise AssertionError(f"multihost: mesh {mesh}")
        mine = host_local_pairs(list(range(batch.shape[0])))
        fn, shard_batch = sharded_match_pipeline(mesh)
        args = shard_batch(batch, t0, t1, ACTOR_ID)
        _reset_counts()
        t_start = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_start) * 1e3
        launches = _counts()
        # the first collective sets the communicator up; a second call is warm
        t_start = time.perf_counter()
        again = fn(*args)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t_start) * 1e3
    finally:
        dist.destroy_process_group()
    _same_match("multihost (one-rank NCCL, warm)", again, [x.cpu() for x in want])
    _same_match("multihost (one-rank NCCL)", got, [x.cpu() for x in want])
    if backend != ("nccl" if device.type == "cuda" else "gloo") or len(mine) != batch.shape[0] \
            or launches["match_pipeline"] != 4:
        raise AssertionError(f"multihost: backend {backend}, {len(mine)} rows, launches {launches}")
    return {"backend": backend, "mesh": mesh.shape, "events": int(np.prod(batch.shape)),
            "matches": int(got[2]), "first_ms": wall_ms, "warm_ms": warm_ms, "launches": launches}


def cli_mesh_range(world, root: str) -> dict:
    """``range --mesh-devices 1`` over the first 512 pairs of the chained
    world through the hermetic node (default crossovers, no checkpoint
    directory): the bundle of the same command without the flag. Over the
    RPC store the scan is the Python walk, so the flag must move the
    full-word mask from its flat launch to its sharded one."""
    store, _, tipsets, _ = world
    argv = [
        "range", "--endpoint", CLI_ENDPOINT,
        "--from-height", str(tipsets[0].height), "--to-height", str(tipsets[MESH_CLI_PAIRS - 1].height),
        "--contract", CLI_ETH, "--event-sig", SIGNATURE, "--topic1", CLI_SUBNET,
        "--storage-slot", CLI_SUBNET, "--chunk-size", str(CLI_CHUNK // 4), "--backend", "gpu",
    ]
    out = {}
    for label, extra, backend, mask, idle in (
        ("plain", [], get_backend("gpu"), "event_match_mask", "event_match_mask_sharded"),
        ("mesh", ["--mesh-devices", "1"], get_backend("gpu", mesh_devices=1),
         "event_match_mask_sharded", "event_match_mask"),
    ):
        path = os.path.join(root, f"cli-mesh-{label}.json")
        recording = _RecordingBackend(backend)
        with _cli_node(_NodeSession(store, tipsets), recording):
            _, wall_ms, launches, snap = _cli(f"cli range ({label})", argv + extra + ["-o", path])
        _require_launched(f"cli range ({label})", launches, ["keccak256_single_block", mask])
        if launches[idle]:
            raise AssertionError(f"cli range ({label}): {idle} launched {launches[idle]} times")
        with open(path) as fh:
            out[label] = {"bundle": fh.read(), "wall_ms": wall_ms, "launches": launches,
                          "checked": _check_recorded(f"cli range ({label})", recording, {})}
    if out["mesh"]["bundle"] != out["plain"]["bundle"]:
        raise AssertionError("cli range --mesh-devices 1: the bundle differs from the run without the flag")
    n_proofs = len(json.loads(out["mesh"]["bundle"])["event_proofs"])
    return {"pairs": MESH_CLI_PAIRS, "proofs": n_proofs,
            "wall_ms": {k: v["wall_ms"] for k, v in out.items()},
            "checked": out["mesh"]["checked"], "launches": out["mesh"]["launches"]}


# --- slice 8: span tracing, the endpoint pool, the chain follower ----------

# the fault-free runs and the lying-endpoint check read the world's first
# 512 pairs (4,096 until phase 32 came)
POOL_PAIRS = 512
POOL_LIAR_PAIRS = 512
POOL_FAULT_RATE = 0.1
# the faulted run reads the world's first 256 pairs: at 10 % faults (bit
# flips among them) each flip demotes an endpoint, so two endpoints spend
# much of a run in lotus_down, and a 4096-pair run aborted typed under
# every one of ten plans (a record-stage read is not retried)
POOL_FAULT_PAIRS = 256
POOL_CHUNK = 8  # the JAX bench.py resilience leg's chunk size
CLI_POOL_PAIRS = 512
CLI_REPLICA = "http://lotus-replica.local/rpc/v1"


class _Collector(http.server.BaseHTTPRequestHandler):
    """A local OTLP/HTTP collector on 127.0.0.1: keeps every POSTed body."""

    def do_POST(self):  # noqa: N802 - http.server's name
        self.server.bodies.append(self.rfile.read(int(self.headers["Content-Length"])))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


def _check_exports(label: str, spans, root: str) -> dict:
    """Write ``spans`` as Chrome trace-event JSON and as OTLP/JSON, POST
    them to a collector on 127.0.0.1; each must parse back to exactly
    ``len(spans)`` spans."""
    chrome, otlp = os.path.join(root, f"{label}.trace.json"), os.path.join(root, f"{label}.otlp.json")
    write_chrome_trace(chrome, spans)
    write_otlp_trace(otlp, spans)
    server = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    server.bodies = []
    thread = threading.Thread(target=server.serve_forever, name="otlp-collector", daemon=True)
    thread.start()
    try:
        posted = post_otlp_trace(f"http://127.0.0.1:{server.server_port}/v1/traces", spans, metrics=Metrics())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    with open(chrome) as fh:
        n_chrome = sum(1 for e in json.load(fh)["traceEvents"] if e["ph"] == "X")
    with open(otlp) as fh:
        n_otlp = len(json.load(fh)["resourceSpans"][0]["scopeSpans"][0]["spans"])
    n_posted = [len(json.loads(b)["resourceSpans"][0]["scopeSpans"][0]["spans"]) for b in server.bodies]
    if not posted or [n_chrome, n_otlp, n_posted] != [len(spans), len(spans), [len(spans)]]:
        raise AssertionError(
            f"{label}: exports hold {n_chrome} / {n_otlp} / {n_posted} spans (posted {posted}), recorded {len(spans)}"
        )
    return {"spans": len(spans), "chrome_bytes": os.path.getsize(chrome), "otlp_bytes": os.path.getsize(otlp)}


def traced_path(world, device, root: str) -> dict:
    """The event world through the generate ∥ verify driver with the span
    collector off and on, interleaved, best of 2 each (the JAX ``bench.py``
    observability leg's way): the same bytes and the same kernel launches
    on and off, every recorded kernel call equal to the plain versions;
    the traced run's spans exported three ways into ``root`` and parsed
    back (phase 31's traceview reads the Chrome file)."""
    store, pairs, n_matching = world
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    spec = _spec()
    plain_cache: dict = {}
    best = {}
    disable_tracing()
    _overlapped_run(store, pairs, spec, chunk_size, budget, backend)  # warm
    for rep in range(2):
        for traced in (False, True):
            recording, seen = _RecordingBackend(backend), []
            trace_metrics = Metrics()
            collector = enable_tracing(metrics=trace_metrics) if traced else None
            try:
                merged, chunk_out, metrics, wall_ms, launches = _overlapped_run(
                    store, pairs, spec, chunk_size, budget, recording, seen
                )
            finally:
                disable_tracing()
            verdicts = [v for chunk, _ in chunk_out for v in chunk]
            if len(verdicts) != n_matching or not all(verdicts):
                raise AssertionError(f"traced path ({traced}): verdicts {verdicts.count(False)} false")
            checked = _check_recorded(f"traced path ({'on' if traced else 'off'})", recording, plain_cache)
            run = {"bundle": merged.to_json(), "wall_ms": wall_ms, "launches": launches, "checked": checked,
                   "proofs": len(merged.event_proofs),
                   "present": [name for name, at in _classes(merged.blocks).items() if at]}
            if traced:
                run["spans"] = collector.snapshot()
                run["recorded"] = trace_metrics.counter_value("trace.spans_recorded")
                run["dropped"] = trace_metrics.counter_value("trace.spans_dropped")
            key = "on" if traced else "off"
            if key not in best or wall_ms < best[key]["wall_ms"]:
                best[key] = run
            if traced and (run["bundle"] != best["off"]["bundle"] or launches != best["off"]["launches"]):
                raise AssertionError(
                    f"traced path: tracing changed the bytes or the launches ({launches} vs {best['off']['launches']})"
                )
    on, off = best["on"], best["off"]
    _require_launched("traced path", on["launches"], on["present"])
    spans = on["spans"]
    if on["recorded"] != len(spans) or on["dropped"]:
        raise AssertionError(f"traced path: {on['recorded']} recorded, {len(spans)} collected, {on['dropped']} dropped")
    names = {}
    for sp in spans:
        names[sp.name] = names.get(sp.name, 0) + 1
    if not {"range_scan", "range_record", "range_merge", "range_verify"} <= set(names):
        raise AssertionError(f"traced path: stage spans missing from {sorted(names)}")
    exports = _check_exports("traced", spans, root)
    return {
        "pairs": len(pairs),
        "proofs": on["proofs"],
        "chunk_size": chunk_size,
        "wall_ms": {"off": off["wall_ms"], "on": on["wall_ms"]},
        "proofs_per_s": {"off": off["proofs"] / off["wall_ms"] * 1e3, "on": on["proofs"] / on["wall_ms"] * 1e3},
        "overhead_pct": 100.0 * (on["wall_ms"] - off["wall_ms"]) / off["wall_ms"],
        "trace.spans_recorded": on["recorded"],
        "trace.spans_dropped": on["dropped"],
        "spans_per_proof": on["recorded"] / on["proofs"],
        "spans_by_name": names,
        "exports": exports,
        "chrome": os.path.join(root, "traced.trace.json"),
        "checked": on["checked"],
        "launches": on["launches"],
    }


class _FlippingNode:
    """A node serving one block with a flipped bit, in single and batch
    reads; every other answer as the wrapped node gives it."""

    def __init__(self, inner, cid):
        self._inner, self._cid = inner, str(cid)
        self.flips = 0

    def post(self, url, data=None, headers=None, timeout=None):
        resp = self._inner.post(url, data=data, headers=headers, timeout=timeout)
        reqs, body = json.loads(data), resp.json()
        by_id = {r["id"]: r for r in (reqs if isinstance(reqs, list) else [reqs])}
        for entry in body if isinstance(body, list) else [body]:
            req = by_id.get(entry.get("id"))
            if (req and req["method"] == "Filecoin.ChainReadObj" and req["params"][0]["/"] == self._cid
                    and isinstance(entry.get("result"), str)):
                raw = bytearray(base64.b64decode(entry["result"]))
                raw[len(raw) // 2] ^= 1
                entry["result"] = base64.b64encode(bytes(raw)).decode("ascii")
                self.flips += 1
        return resp


def _pool_client(name: str, session, seed: int, metrics, max_retries: int = 3):
    """A pool endpoint as the JAX ``bench.py`` resilience leg builds it:
    full-jitter backoff of 0.5–2 ms from a seeded jitter source."""
    return LotusClient(f"http://{name}", session=session, backoff_base_s=0.0005, backoff_max_s=0.002,
                       rng=random.Random(seed), metrics=metrics, max_retries=max_retries)


def _plane_run(reader, pairs, backend, budget, chunk_size, metrics):
    """One pipelined run over ``reader`` (a pool or a client) behind the
    fetch plane at speculate depth 1, counts from 0: (bundle JSON, wall
    ms, launches)."""
    gc.collect()
    plane = FetchPlane(reader, speculate_depth=1, backend=backend, metrics=metrics)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        bundle = generate_event_proofs_for_range_pipelined(
            PlaneBlockstore(plane), pairs, _spec(), chunk_size=chunk_size, match_backend=backend,
            metrics=metrics, threads=budget.total, scan_threads=budget.scan_workers,
            record_workers=budget.record_workers, scan_retries=2,
        )
        torch.cuda.synchronize()
    finally:
        plane.close()
    return bundle.to_json(), (time.perf_counter() - t0) * 1e3, _counts()


POOL_PREFIXES = ("rpc.", "failover.", "degraded.", "verify.", "fetch.batches")


def pool_path(world, seed: int) -> dict:
    """The event world's first `POOL_PAIRS` pairs read through two
    endpoints behind an `EndpointPool`
    (the JAX ``bench.py`` resilience leg's pool: breaker threshold 3,
    reset 50 ms, backoff 0.5–2 ms, chunks of 8 pairs, 2 scan retries)
    behind the fetch plane, every landed
    wave of two or more blocks verified by the pool on the card
    (``IPC_VERIFY_MIN_BYTES=0``): fault-free with integrity on (the pool's
    lane), fault-free with integrity off (one client that claims to
    verify: the plane skips the lane), and at 10 % injected faults on both
    endpoints over the world's first 256 pairs (a typed abort moves to the
    next seed, as in the leg). Each
    bundle is the in-memory one; every recorded lane batch is held against
    the plain versions; then the failover recovery time, and a third
    endpoint serving one flipped block on a prefix of the world: demoted,
    the bundle unchanged."""
    store, pairs, _ = world
    pairs = pairs[:POOL_PAIRS]
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    chunk_size = POOL_CHUNK
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend)
    expected_json, n_proofs = expected.to_json(), len(expected.event_proofs)
    runs = {}
    plain_cache: dict = {}
    with _env("IPC_VERIFY_MIN_BYTES", "0"):
        # fault-free, integrity on: the pool verifies every wave on the card
        metrics, recording = Metrics(), _RecordingBackend(backend)
        pool = EndpointPool([_pool_client(f"pool-{i}", LocalLotusSession(store), seed + i, metrics) for i in range(2)],
                            breaker_threshold=3, breaker_reset_s=0.05, metrics=metrics, backend=recording)
        try:
            with _verify_calls(failover_mod) as lane:
                bundle, wall_ms, launches = _plane_run(pool, pairs, backend, budget, chunk_size, metrics)
        finally:
            pool.close()
        if bundle != expected_json:
            raise AssertionError("pool (integrity on): the bundle differs from the in-memory one")
        # the batch reads' latency, lane call included, is what the pool's
        # p99-driven hedge delay reads
        with pool._lock:
            read_ms = {k: v * 1e3 for k, v in pool._latency.percentiles((0.5, 0.99)).items()}
        _require_blake2b("pool (integrity on)", launches)
        if metrics.counter_value("verify.device_blocks") == 0:
            raise AssertionError("pool (integrity on): no wave reached the card")
        runs["on"] = {"wall_ms": wall_ms, "launches": launches, "health": pool.health(),
                      "batch_read_ms": read_ms, "hedge_delay_ms_at_5ms_floor": max(5.0, read_ms.get("p99", 0.0)),
                      "lane_ms_per_call": sum(ms for _, ms in lane) / max(1, len(lane)), "lane_calls": len(lane),
                      "counters": {k: v for k, v in sorted(metrics.counters.items()) if k.startswith(POOL_PREFIXES)},
                      "checked": _check_recorded("pool (integrity on)", recording, plain_cache)}
        # fault-free, integrity off: the "pool already verifies" hatch
        metrics = Metrics()
        trusting = _pool_client("trusting", LocalLotusSession(store), seed, metrics)
        trusting.verifies_integrity = True
        bundle, wall_ms, off_launches = _plane_run(trusting, pairs, backend, budget, chunk_size, metrics)
        if bundle != expected_json:
            raise AssertionError("pool (integrity off): the bundle differs from the in-memory one")
        runs["off"] = {"wall_ms": wall_ms, "launches": off_launches}
        # 10 % faults on both endpoints, over a prefix of the world
        fault_pairs = pairs[:POOL_FAULT_PAIRS]
        fault_expected = generate_event_proofs_for_range(store, fault_pairs, _spec(), match_backend=backend)
        aborts = []
        for attempt in range(10):
            metrics, recording = Metrics(), _RecordingBackend(backend)
            clients = [
                _pool_client(
                    f"faulty-{i}",
                    FaultySession(LocalLotusSession(store), FaultPlan(attempt * 101 + i, fault_rate=POOL_FAULT_RATE),
                                  sleep=lambda s: None),
                    seed + attempt + i, metrics,
                )
                for i in range(2)
            ]
            pool = EndpointPool(clients, breaker_threshold=3, breaker_reset_s=0.05, metrics=metrics, backend=recording)
            try:
                bundle, wall_ms, f_launches = _plane_run(pool, fault_pairs, backend, budget, chunk_size, metrics)
            except VerifyLaneError:
                raise
            except (RuntimeError, ConnectionError, TimeoutError, OSError) as exc:
                _log(f"pool (faulted, plan {attempt}): typed abort {type(exc).__name__}: {exc}")
                aborts.append(type(exc).__name__)
                continue
            finally:
                pool.close()
            if bundle != fault_expected.to_json():
                raise AssertionError(f"pool (faulted, plan {attempt}): the bundle differs from the in-memory one")
            runs["faulted"] = {
                "pairs": len(fault_pairs), "proofs": len(fault_expected.event_proofs), "aborts": aborts,
                "plan": attempt, "wall_ms": wall_ms, "launches": f_launches, "health": pool.health(),
                "counters": {k: v for k, v in sorted(metrics.counters.items()) if k.startswith(POOL_PREFIXES)},
                "checked": _check_recorded("pool (faulted)", recording, plain_cache),
            }
            break
        else:
            raise AssertionError("pool (faulted): every fault plan aborted")
        # a third endpoint serving one flipped block, first in the routing
        liar_pairs = pairs[:POOL_LIAR_PAIRS]
        liar_expected = generate_event_proofs_for_range(store, liar_pairs, _spec(), match_backend=backend).to_json()
        target = UnifiedProofBundle.from_json(liar_expected).blocks[0].cid
        metrics, recording = Metrics(), _RecordingBackend(backend)
        liar = _FlippingNode(LocalLotusSession(store), target)
        pool = EndpointPool(
            [_pool_client("liar", liar, seed, metrics)]
            + [_pool_client(f"honest-{i}", LocalLotusSession(store), seed + i, metrics) for i in range(2)],
            breaker_threshold=3, breaker_reset_s=0.05, metrics=metrics, backend=recording,
        )
        try:
            bundle, l_wall_ms, l_launches = _plane_run(pool, liar_pairs, backend, budget, chunk_size, metrics)
        finally:
            pool.close()
        health = pool.health()
        if bundle != liar_expected or not liar.flips or health["endpoints"][0]["integrity_demotions"] < 1:
            raise AssertionError(f"pool (lying endpoint): flips {liar.flips}, health {health}")
        runs["liar"] = {"pairs": len(liar_pairs), "flips": liar.flips, "wall_ms": l_wall_ms, "health": health,
                        "integrity_failures": metrics.counter_value("rpc.integrity_failures"),
                        "launches": l_launches, "checked": _check_recorded("pool (liar)", recording, plain_cache)}

    class _Dead:
        def post(self, url, data=None, headers=None, timeout=None):
            raise ConnectionError("dead endpoint")

    probe = UnifiedProofBundle.from_json(expected_json).blocks[0]
    recovery_s = float("inf")
    for rep in range(5):
        pool = EndpointPool([_pool_client("dead", _Dead(), rep, Metrics(), max_retries=1),
                             _pool_client("healthy", LocalLotusSession(store), rep, Metrics())],
                            breaker_threshold=1, backend=backend, metrics=Metrics())
        pool._endpoints[0].score = 2.0  # the dead endpoint routes first
        t0 = time.perf_counter()
        data = pool.chain_read_obj(probe.cid)
        recovery_s = min(recovery_s, time.perf_counter() - t0)
        pool.close()
        if data != probe.data:
            raise AssertionError("pool recovery: the healthy endpoint's block differs")
    on, off, faulted = runs["on"], runs["off"], runs["faulted"]
    return {
        "pairs": len(pairs),
        "proofs": n_proofs,
        "chunk_size": chunk_size,
        "proofs_per_s": {"on": n_proofs / on["wall_ms"] * 1e3, "off": n_proofs / off["wall_ms"] * 1e3,
                         "faulted": faulted["proofs"] / faulted["wall_ms"] * 1e3},
        "wall_ms": {k: runs[k]["wall_ms"] for k in ("on", "off", "faulted")},
        "integrity_overhead_pct": 100.0 * (on["wall_ms"] - off["wall_ms"]) / off["wall_ms"],
        "recovery_ms": recovery_s * 1e3,
        "runs": runs,
        "launches": on["launches"],
        "host": _host_info(),
    }


# the range over the warmed tier reads the chain's first 1,024 pairs (the
# whole chain until phase 32 came); the follower still warms every height
FOLLOW_RANGE_PAIRS = 1024


def follower_path(world, root: str) -> dict:
    """A `ChainFollower` (lag 1, from the chain's first height, up to 4,096
    heights a poll) over the chained world's hermetic node warms a
    `TieredBlockstore` over a `SegmentStore`, every landed wave of two or
    more blocks verified on the card (``IPC_VERIFY_MIN_BYTES=0``), polled
    until the head; then the range over a fresh memory cache on the warmed
    disk (the JAX ``bench.py`` storage leg's follower half): the in-memory
    bytes, and the share of its reads the follower anticipated. A second
    node serving one corrupt spine block: one ``follow.errors``, the block
    never stored."""
    store, pairs, tipsets, _ = world
    range_pairs = pairs[:FOLLOW_RANGE_PAIRS]
    backend = get_backend("gpu")
    expected = generate_event_proofs_for_range(store, range_pairs, _spec(), match_backend=backend).to_json()
    metrics, recording = Metrics(), _RecordingBackend(backend)
    disk = SegmentStore(os.path.join(root, "follow"), backend=backend, metrics=metrics)
    client = LotusClient(CLI_ENDPOINT, session=_NodeSession(store, tipsets), metrics=metrics)
    tier = TieredBlockstore(RpcBlockstore(client, metrics=metrics), disk, metrics=metrics)
    follower = ChainFollower(client, tier, metrics=metrics, lag=1, start_height=tipsets[0].height,
                             max_tipsets_per_poll=len(tipsets), backend=recording)
    try:
        with _env("IPC_VERIFY_MIN_BYTES", "0"), _verify_calls(follower_mod) as waves:
            gc.collect()
            _reset_counts()
            t0 = time.perf_counter()
            polls = [follower.poll_once()]
            while polls[-1]:
                polls.append(follower.poll_once())
            torch.cuda.synchronize()
            follow_ms = (time.perf_counter() - t0) * 1e3
            launches = _counts()
        walked = tipsets[-1].height - 1 - tipsets[0].height + 1
        counters = {k: v for k, v in sorted(metrics.counters.items()) if k.startswith(("follow.", "verify.", "rpc."))}
        if counters.get("follow.errors", 0) or counters.get("follow.tipsets") != walked:
            raise AssertionError(f"follower: {counters} over {walked} heights")
        _require_blake2b("follower", launches)
        checked = _check_recorded("follower", recording, {})
        stats = disk.stats()
        # the range over a fresh memory cache on the warmed disk
        r_metrics = Metrics()
        r_client = LotusClient(CLI_ENDPOINT, session=_NodeSession(store, tipsets), metrics=r_metrics)
        r_tier = TieredBlockstore(RpcBlockstore(r_client, metrics=r_metrics), disk, metrics=r_metrics)
        budget = resolve_thread_budget()
        chunk_size = max(1, min(1024, len(range_pairs) // max(4, 2 * budget.scan_workers)))
        disk_hits0 = metrics.counter_value("storex.disk_hits")  # the disk counts into its own metrics
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range_pipelined(
            r_tier, range_pairs, _spec(), chunk_size=chunk_size, match_backend=backend, metrics=r_metrics,
            threads=budget.total, scan_threads=budget.scan_workers, record_workers=budget.record_workers,
        )
        range_ms = (time.perf_counter() - t0) * 1e3
    finally:
        disk.close()
    if bundle.to_json() != expected:
        raise AssertionError("follower: the range over the warmed tier differs from the in-memory bundle")
    disk_hits = metrics.counter_value("storex.disk_hits") - disk_hits0
    gets = r_tier.hits + r_tier.misses
    # a second node that serves one spine block corrupt (the first
    # height's messages root, read in the spine wave only)
    spine = tipsets[0].blocks[0].messages
    c_metrics = Metrics()
    c_disk = SegmentStore(os.path.join(root, "follow-corrupt"), backend=backend, metrics=c_metrics)
    node = _FlippingNode(_NodeSession(store, tipsets), spine)
    c_client = LotusClient(CLI_REPLICA, session=node, metrics=c_metrics)
    c_tier = TieredBlockstore(RpcBlockstore(c_client, metrics=c_metrics), c_disk, metrics=c_metrics)
    try:
        corrupt = ChainFollower(c_client, c_tier, metrics=c_metrics, lag=len(tipsets) - 1,
                                start_height=tipsets[0].height, backend=backend)
        with _env("IPC_VERIFY_MIN_BYTES", "0"):
            warmed = corrupt.poll_once()
        stored = c_tier.has_local(spine)
    finally:
        c_disk.close()
    if warmed != 1 or node.flips != 1 or c_metrics.counter_value("follow.errors") != 1 or stored:
        raise AssertionError(
            f"follower (corrupt spine): warmed {warmed}, flips {node.flips}, "
            f"follow.errors {c_metrics.counter_value('follow.errors')}, stored {stored}"
        )
    multi = [n for n, _ in waves if n >= 2]
    return {
        "heights": walked,
        "polls": len(polls),
        "follow_ms": follow_ms,
        "ms_per_height": follow_ms / walked,
        "blocks_prefetched": counters.get("follow.blocks_prefetched", 0),
        "waves": {"total": len(waves), "multi_block": len(multi), "largest": max(multi, default=0),
                  "verify_ms": sum(ms for _, ms in waves)},
        "disk": stats,
        "counters": counters,
        "range_ms": range_ms,
        "range_rpc_calls": r_metrics.counter_value("rpc.calls"),
        "prefetch_hit_ratio": (r_tier.hits + disk_hits) / gets if gets else None,
        "corrupt_spine": {"follow.errors": 1, "stored": stored},
        "checked": checked,
        "launches": launches,
    }


def cli_pool_range(world, root: str) -> dict:
    """``range --endpoints <replica> --hedge-ms 5 --breaker-threshold 3
    --trace-out F --trace-otlp G --job-dir J`` over the first 512 pairs of
    the chained world, two hermetic nodes, every landed wave of two or more
    blocks verified by the pool on the card (``IPC_VERIFY_MIN_BYTES=0``):
    the bundle of the same command without the flags; F holds the
    command's root, ``rpc.*``, ``pool.*``, pipeline-stage and
    ``journal.append`` spans in one trace, and G the same spans."""
    store, _, tipsets, _ = world
    argv = [
        "range", "--endpoint", CLI_ENDPOINT,
        "--from-height", str(tipsets[0].height), "--to-height", str(tipsets[CLI_POOL_PAIRS - 1].height),
        "--contract", CLI_ETH, "--event-sig", SIGNATURE, "--topic1", CLI_SUBNET,
        "--storage-slot", CLI_SUBNET, "--chunk-size", str(CLI_CHUNK // 4), "--backend", "gpu",
    ]
    backend = get_backend("gpu")
    chrome, otlp = os.path.join(root, "cli-pool.trace.json"), os.path.join(root, "cli-pool.otlp.json")
    out = {}
    for label, extra in (
        ("plain", []),
        ("pool", ["--endpoints", CLI_REPLICA, "--hedge-ms", "5", "--breaker-threshold", "3",
                  "--trace-out", chrome, "--trace-otlp", otlp, "--job-dir", os.path.join(root, "cli-pool-job")]),
    ):
        path = os.path.join(root, f"cli-pool-{label}.json")
        recording = _RecordingBackend(backend)
        sessions = {CLI_ENDPOINT: _NodeSession(store, tipsets), CLI_REPLICA: _NodeSession(store, tipsets)}
        with _cli_node(sessions, recording), _env("IPC_VERIFY_MIN_BYTES", "0"):
            _, wall_ms, launches, snap = _cli(f"cli range ({label})", argv + extra + ["-o", path])
        with open(path) as fh:
            out[label] = {"bundle": fh.read(), "wall_ms": wall_ms, "launches": launches, "snap": snap,
                          "checked": _check_recorded(f"cli range ({label})", recording, {}),
                          "methods": {u: s.methods.get("Filecoin.ChainReadObj", 0) for u, s in sessions.items()}}
    if out["pool"]["bundle"] != out["plain"]["bundle"]:
        raise AssertionError("cli range --endpoints: the bundle differs from the run without the flags")
    pool = out["pool"]
    _require_blake2b("cli range --endpoints", pool["launches"])
    with open(chrome) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    with open(otlp) as fh:
        n_otlp = len(json.load(fh)["resourceSpans"][0]["scopeSpans"][0]["spans"])
    names = {e["name"] for e in events}
    traces = {e["args"]["trace_id"] for e in events}
    wanted = [
        any(n.startswith("rpc.") for n in names), names & {"pool.read", "pool.read_many"},
        names & {"range_scan", "range_record", "range_merge"}, "journal.append" in names, "cli.range" in names,
    ]
    if not all(wanted) or len(traces) != 1 or n_otlp != len(events):
        raise AssertionError(f"cli range --trace-out: {len(traces)} traces, {n_otlp} OTLP spans, names {sorted(names)}")
    counters = pool["snap"]["counters"]
    return {
        "pairs": CLI_POOL_PAIRS,
        "proofs": len(json.loads(pool["bundle"])["event_proofs"]),
        "wall_ms": {k: v["wall_ms"] for k, v in out.items()},
        "spans": len(events),
        "span_names": sorted(names),
        "reads_by_endpoint": pool["methods"],
        "counters": {k: v for k, v in sorted(counters.items()) if k.startswith(POOL_PREFIXES)},
        "checked": pool["checked"],
        "launches": pool["launches"],
    }


def autotune_phase(root: str) -> dict:
    """`autotune_crossover` on the card, its record under the port's own
    file name."""
    store_dir = os.path.join(root, "autotune")
    _reset_counts()
    record = autotune_crossover(store_dir, quick=False, force=True)
    launches = _counts()
    names = sorted(os.listdir(store_dir))
    if names != ["verify_autotune_cuda.json"]:
        raise AssertionError(f"autotune: files {names}")
    if load_autotune(store_dir) != record["min_bytes"] or len(record["samples"]) != 4:
        raise AssertionError(f"autotune: record {record}")
    _require_launched("autotune", launches, SIZE_CLASSES[2:])
    return {"record": record, "launches": launches}


# -- the serve plane, the witness wire and the registry (slice 9) ----------

SERVE_EVENTS = 768  # the JAX bench.py serve leg's chain: one contract, 768 events
SERVE_REQUESTS = 256
SERVE_CLIENTS = 32
SERVE_WAIT_MS = 4.0
DIET_PAIRS = 64  # the witness leg's two-pass comparison: min(64, tipsets)
DIET_EPOCHS = 8  # the witness leg's delta run: 8 consecutive epochs
REGISTRY_REQUESTS = 96
REGISTRY_APPENDS = 2048
REGISTRY_SHARDS = 4
REGISTRY_T0 = 1_700_000_000.0


def _service_device(device):
    """ServiceConfig's device: None (the card) on the card, "cpu" for a
    rehearsal of the phase on the CPU."""
    return None if torch.device(device).type == "cuda" else "cpu"


def _closed_loop(n_requests: int, clients: int, call) -> "tuple[list, float]":
    """``clients`` threads take request indexes from one counter until
    ``n_requests`` are served; returns (responses by index, wall seconds)."""
    it = iter(range(n_requests))
    lock = threading.Lock()
    out: list = [None] * n_requests
    errors: list = []

    def client():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            try:
                out[i] = call(i)
            except BaseException as exc:  # re-raised below, on the main thread
                errors.append(exc)
                return

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a serve client did not finish within 600 s")
    if errors:
        raise errors[0]
    return out, wall


def _serve_launch_set(present, batches: int, txmeta_batches: int) -> "dict[str, int]":
    """The blake2b launches ``batches`` merged verify batches make: the
    TxMeta batch (single-block) of each of ``txmeta_batches``, plus, with
    the witness CIDs on, one launch per size class ``present`` in each."""
    want = dict.fromkeys(SIZE_CLASSES, 0)
    want["blake2b256_single_block"] = txmeta_batches
    for name in present:
        want[name] += batches
    return want


def _require_launch_set(label: str, launches: "dict[str, int]", want: "dict[str, int]") -> None:
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"{label}: blake2b launches {got}, expected {want}")


def serve_chain():
    """The JAX bench.py serve leg's world: one contract holding the topdown
    nonce slot, 768 matching events, and its full bundle."""
    slot = calculate_storage_slot(TOPIC1, 0)
    world = build_chain(
        [ContractFixture(actor_id=ACTOR_ID, storage={slot: (42).to_bytes(2, "big")})],
        [
            [EventFixture(emitter=ACTOR_ID, signature=SIGNATURE, topic1=TOPIC1, data=i.to_bytes(32, "big"))]
            for i in range(SERVE_EVENTS)
        ],
    )
    return world, slot


def serve_verify_phase(device) -> dict:
    """256 single-proof requests over the 768-event chain's full bundle:
    the sequential baseline, then 32 closed-loop clients through
    `ProofService` (max_batch 32, 4 ms window, 2 workers) with the witness
    CIDs off and on. The verdicts of the three runs are equal; each merged
    batch launches blake2b once per size class (the TxMeta batch, plus the
    merged witness with CIDs on); a flipped witness byte in one request is
    rejected without touching its neighbours; the card's digests of one
    merged witness equal the plain versions' and the CIDs."""
    backend = get_backend("gpu", device=device)
    plain = get_backend("gpu", device="cpu")
    world, slot = serve_chain()
    full = generate_proof_bundle(
        world.store, world.parent, world.child,
        [StorageProofSpec(actor_id=ACTOR_ID, slot=slot)],
        [EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)],
        match_backend=backend,
    )
    if len(full.event_proofs) != SERVE_EVENTS:
        raise AssertionError(f"serve verify: {len(full.event_proofs)} event proofs")
    requests = [
        UnifiedProofBundle([], [full.event_proofs[i % SERVE_EVENTS]], full.blocks)
        for i in range(SERVE_REQUESTS)
    ]
    present = [name for name, rows in _classes(full.blocks).items() if rows]

    sequential_verify_baseline(requests[:4], cid_backend=backend)  # warm
    gc.collect()
    _reset_counts()
    t0 = time.perf_counter()
    seq = sequential_verify_baseline(requests, cid_backend=backend)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    seq_launches = _counts()
    verdicts = [(r.storage_results, r.event_results) for r in seq]
    if verdicts != [([], [True])] * SERVE_REQUESTS:
        raise AssertionError("serve verify: a sequential verdict is false")
    _require_launch_set("serve verify, sequential", seq_launches, _serve_launch_set([], 0, SERVE_REQUESTS))

    runs = {}
    for cids in (False, True):
        service = ProofService(config=ServiceConfig(
            max_batch=SERVE_CLIENTS, max_wait_ms=SERVE_WAIT_MS, queue_capacity=max(512, 2 * SERVE_REQUESTS),
            workers=2, verify_witness_cids=cids, device=_service_device(device),
        ))
        try:
            gc.collect()
            _reset_counts()
            responses, wall = _closed_loop(SERVE_REQUESTS, SERVE_CLIENTS, lambda i: service.verify(requests[i]))
            torch.cuda.synchronize()
            launches = _counts()
            snap = service.metrics_snapshot()
        finally:
            service.drain()
        if [(r.storage_results, r.event_results) for r in responses] != verdicts:
            raise AssertionError(f"serve verify (cids {cids}): verdicts differ from the sequential run")
        batches = snap["counters"]["serve.batches.verify"]
        label = "serve verify, cids" if cids else "serve verify"
        _require_launch_set(label, launches, _serve_launch_set(present if cids else [], batches, batches))
        hist = snap.get("histograms", {})
        runs["cids" if cids else "plain"] = {
            "rps": SERVE_REQUESTS / wall,
            "wall_ms": wall * 1e3,
            "p99_latency_ms": hist.get("serve.latency_ms.verify", {}).get("p99"),
            "mean_batch": hist.get("serve.batch_size.verify", {}).get("mean"),
            "batches": batches,
            "launches": launches,
        }

    # one request with a flipped witness byte among 31 honest ones: its own
    # sub-merge fails the CID recompute, the others verify
    index = len(full.blocks) // 2
    flipped = bytearray(full.blocks[index].data)
    flipped[len(flipped) // 2] ^= 0x01
    liar = UnifiedProofBundle(
        [], [full.event_proofs[0]],
        full.blocks[:index] + [ProofBlock(full.blocks[index].cid, bytes(flipped))] + full.blocks[index + 1 :],
    )
    with ProofService(config=ServiceConfig(
        max_batch=SERVE_CLIENTS, max_wait_ms=200.0, verify_witness_cids=True, device=_service_device(device),
    )) as service:
        pendings = [service.submit_verify(liar if i == 7 else requests[i]) for i in range(SERVE_CLIENTS)]
        outcomes = []
        for p in pendings:
            try:
                outcomes.append(p.result(timeout=300).event_results)
            except ValueError:
                outcomes.append("rejected")
        merges = service.metrics.snapshot()["timers"]["serve.verify_batch"]["calls"]
    if outcomes != [[True]] * 7 + ["rejected"] + [[True]] * (SERVE_CLIENTS - 8) or merges != 2:
        raise AssertionError(f"serve verify: the tampered request's outcomes {outcomes}, {merges} sub-merges")

    # the card's digests of the merged witness against the plain versions
    data = [b.data for b in full.blocks]
    card = backend.blake2b256_batch(data)
    if card != plain.blake2b256_batch(data) or card != [b.cid.digest for b in full.blocks]:
        raise AssertionError("serve verify: the card's witness digests differ from the plain versions")
    _check_witness_shapes(full.blocks, device)
    plain_run, cid_run = runs["plain"], runs["cids"]
    return {
        "requests": SERVE_REQUESTS,
        "clients": SERVE_CLIENTS,
        "witness_blocks": len(full.blocks),
        "witness_bytes": full.witness_bytes(),
        "by_class": {name: len(rows) for name, rows in _classes(full.blocks).items()},
        "serve_sequential_rps": SERVE_REQUESTS / seq_s,
        "serve_batched_rps": plain_run["rps"],
        "serve_batched_rps_cids": cid_run["rps"],
        "serve_speedup_vs_sequential": plain_run["rps"] * seq_s / SERVE_REQUESTS,
        "serve_p99_latency_ms": plain_run["p99_latency_ms"],
        "serve_mean_batch": plain_run["mean_batch"],
        "serve.batches.verify": plain_run["batches"],
        "runs": runs,
        "sequential_ms": seq_s * 1e3,
        "tampered_sub_merges": merges,
        "launches": plain_run["launches"],
        "cids_launches": cid_run["launches"],
        "sequential_launches": seq_launches,
    }


def _group_by_witness(responses) -> "list[UnifiedProofBundle]":
    """The responses of each generate batch (they share one witness list)
    merged into one bundle: verifying it verifies every response of the
    batch, verdict for verdict."""
    groups: "dict[int, UnifiedProofBundle]" = {}
    for resp in responses:
        key = id(resp.bundle.blocks)
        if key not in groups:
            groups[key] = UnifiedProofBundle([], [], resp.bundle.blocks)
        groups[key].event_proofs.extend(resp.bundle.event_proofs)
    return list(groups.values())


def serve_generate_phase(world, device, root: str) -> dict:
    """32 closed-loop clients ask `ProofService.generate` for one pair each
    until every pair of the 4,096-pair event world is served: each
    response's event proofs are those of generating its pair alone, and each
    batch's shared witness verifies every claim of the batch on the card.
    Then one batch through a ``range_job_dir`` (``journal_ms`` in its
    timing), and one range window with the topdown nonce slot over the
    64-pair mixed world (the slot keccak on the card)."""
    store, pairs, n_matching = world
    backend = get_backend("gpu", device=device)
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    svc_device = _service_device(device)
    gc.collect()
    service = ProofService(store=store, spec=spec, config=ServiceConfig(
        max_batch=SERVE_CLIENTS, max_wait_ms=SERVE_WAIT_MS, queue_capacity=2 * len(pairs), workers=2,
        device=svc_device,
    ))
    try:
        _reset_counts()
        responses, wall = _closed_loop(len(pairs), SERVE_CLIENTS, lambda i: service.generate(pairs[i]))
        torch.cuda.synchronize()
        generate_launches = _counts()
        snap = service.metrics_snapshot()
    finally:
        service.drain()
    t0 = time.perf_counter()
    groups = _group_by_witness(responses)
    for group in groups:
        result = verify_proof_bundle(group, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend)
        if not result.all_valid():
            raise AssertionError("serve generate: a served claim does not verify over its batch's witness")
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    _require_blake2b("serve generate", launches)
    served = sum(len(r.bundle.event_proofs) for r in responses)
    if served != n_matching:
        raise AssertionError(f"serve generate: {served} proofs served for {n_matching} matching receipts")
    t0 = time.perf_counter()
    for pair, resp in zip(pairs, responses):
        solo = generate_event_proofs_for_range(store, [pair], spec, match_backend=backend)
        if [p.to_json_obj() for p in resp.bundle.event_proofs] != [p.to_json_obj() for p in solo.event_proofs]:
            raise AssertionError("serve generate: a response differs from generating its pair alone")
    solo_ms = (time.perf_counter() - t0) * 1e3
    hist = snap.get("histograms", {})

    # one batch through the write-ahead journal
    job_dir = os.path.join(root, "serve-jobs")
    with ProofService(store=store, spec=spec, config=ServiceConfig(
        max_batch=SERVE_CLIENTS, max_wait_ms=200.0, workers=2, range_job_dir=job_dir, device=svc_device,
    )) as journaled:
        pendings = [journaled.submit_generate(p) for p in pairs[:SERVE_CLIENTS]]
        jobbed = [p.result(timeout=300) for p in pendings]
    journal_ms = [r.server_timing.get("journal_ms", 0) for r in jobbed]
    if not all(ms > 0 for ms in journal_ms) or {r.batch_size for r in jobbed} != {SERVE_CLIENTS}:
        raise AssertionError(f"serve generate: journal_ms {journal_ms}")
    for resp, want in zip(jobbed, responses):
        if resp.bundle.event_proofs != want.bundle.event_proofs:
            raise AssertionError("serve generate: a journaled response differs")

    # one range window with the topdown nonce slot (the slot keccak)
    mixed_store, mixed_pairs, _ = build_range_world(64, 16, 4, 0.01)
    slot_spec = MappingSlotSpec(ACTOR_ID, TOPIC1, 0)
    with ProofService(store=mixed_store, spec=spec, config=ServiceConfig(device=svc_device)) as windows:
        _reset_counts()
        window = windows.submit_range_window(mixed_pairs, storage_specs=[slot_spec]).result(timeout=300)
        torch.cuda.synchronize()
        window_launches = _counts()
    _require_launched("serve range window", window_launches, ["keccak256_single_block"])
    want = generate_event_proofs_for_range_chunked(
        mixed_store, mixed_pairs, spec, chunk_size=len(mixed_pairs), match_backend=backend,
        storage_specs=[slot_spec],
    )
    if window.to_json() != want.to_json() or len(window.storage_proofs) != len(mixed_pairs):
        raise AssertionError("serve range window: the window's bundle differs from the chunked driver's")
    if not verify_proof_bundle(window, TrustPolicy.accept_all(), verify_witness_cids=True,
                               cid_backend=backend).all_valid():
        raise AssertionError("serve range window: a verdict is false")
    _check_slot_keccak([slot_spec.key32() + slot_spec.slot_index.to_bytes(32, "big")], device)
    _check_witness_shapes(groups[0].blocks, device)
    return {
        "pairs": len(pairs),
        "proofs": served,
        "proofs_per_s": served / wall,
        "pairs_per_s": len(pairs) / wall,
        "wall_ms": wall * 1e3,
        "batches": snap["counters"]["serve.batches.generate"],
        "mean_batch": hist.get("serve.batch_size.generate", {}).get("mean"),
        "p99_latency_ms": hist.get("serve.latency_ms.generate", {}).get("p99"),
        "verify_ms": verify_ms,
        "solo_check_ms": solo_ms,
        "journal_ms": journal_ms[0],
        "window_storage_proofs": len(window.storage_proofs),
        "generate_launches": generate_launches,
        "launches": launches,
        "window_launches": window_launches,
    }


def _wire_bytes(obj) -> int:
    return len(json.dumps(obj, sort_keys=True, separators=(",", ":")))


def witness_diet_phase(device) -> dict:
    """The JAX bench.py witness leg on the port: the two-pass against the
    single-pass witness over 64 pairs; then on the 8-pair match-dense world
    the wire bytes per proof at K = 1, 16 and 256 aggregated claims, the
    delta ratio over 8 consecutive epochs (each delta rebuilt byte for
    byte), and the zlib (and zstd, where it imports) frame ratio; and
    `verify_aggregated` of the K = 256 claims with the witness CIDs on the
    card: one launch set, each claim's verdict that of verifying it alone."""
    backend = get_backend("gpu", device=device)
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    _reset_counts()
    store, pairs, _ = build_range_world(DIET_PAIRS, 16, 4, 0.01, base_height=30_000_000)
    bundle = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend)
    two_pass = bundle.witness_bytes()
    needed = set()
    for pair in pairs:
        needed |= single_pass_witness_cids(store, pair.parent, pair.child)
    single_pass = sum(len(store.get(cid) or b"") for cid in needed)

    dstore, dpairs, _ = build_range_world(DIET_EPOCHS, 16, 4, 0.5, base_height=30_000_000)
    solo = generate_event_proofs_for_range(dstore, dpairs[:1], spec, match_backend=backend)
    distinct = generate_event_proofs_for_range(dstore, dpairs[:4], spec, match_backend=backend)
    bytes_per_proof = {}
    for k in (1, 16, 256):
        d = min(4, k)
        bundle_k = solo if d == 1 else distinct
        agg = aggregate_range_bundle(bundle_k, dpairs, list(range(d)), claim_indexes=[i % d for i in range(k)])
        bytes_per_proof[k] = _wire_bytes({"bundle": bundle_k.to_json_obj(), "claims": agg.claims_json()}) / k

    prefix = [
        generate_event_proofs_for_range(dstore, dpairs[: i + 1], spec, match_backend=backend)
        for i in range(DIET_EPOCHS)
    ]
    ratios = []
    for base, nxt in zip(prefix, prefix[1:]):
        dobj = encode_delta(nxt, base.cid_set(), base.digest())
        if apply_delta(json.loads(json.dumps(dobj)), base).to_json() != nxt.to_json():
            raise AssertionError("witness diet: a delta does not rebuild its bundle")
        ratios.append(_wire_bytes({"bundle_delta": dobj}) / _wire_bytes({"bundle": nxt.to_json_obj()}))
    packed = len(pack_blocks(distinct.blocks))
    frame_ratio = {}
    for encoding in ("zlib", "zstd"):
        if encoding not in supported_encodings():
            frame_ratio[encoding] = "does not import"
            continue
        frame = compress_blocks(distinct.blocks, encoding)
        if [b.to_json_obj() for b in decompress_blocks(frame)] != distinct.to_json_obj()["blocks"]:
            raise AssertionError(f"witness diet: the {encoding} frame does not expand to the blocks")
        frame_ratio[encoding] = len(base64.b64decode(frame["frame"])) / packed
    torch.cuda.synchronize()
    launches = _counts()

    agg = aggregate_range_bundle(distinct, dpairs, [0, 1, 2, 3], claim_indexes=[i % 4 for i in range(256)])
    _reset_counts()
    t0 = time.perf_counter()
    verdicts = verify_aggregated(
        agg, TrustPolicy.accept_all(), verify_witness_cids=True,
        cid_backend=None if torch.device(device).type == "cuda" else backend,
    )
    torch.cuda.synchronize()
    agg_ms = (time.perf_counter() - t0) * 1e3
    agg_launches = _counts()
    present = [name for name, rows in _classes(distinct.blocks).items() if rows]
    _require_launch_set("witness aggregate verify", agg_launches, _serve_launch_set(present, 1, 1))
    t0 = time.perf_counter()
    for i, verdict in enumerate(verdicts):
        alone = verify_proof_bundle(agg.split_claim(i), TrustPolicy.accept_all(), verify_witness_cids=True,
                                    cid_backend=backend)
        if (alone.storage_results, alone.event_results) != (verdict.storage_results, verdict.event_results):
            raise AssertionError(f"witness aggregate verify: claim {i}'s verdict differs from verifying it alone")
    torch.cuda.synchronize()
    per_claim_ms = (time.perf_counter() - t0) * 1e3
    if len(verdicts) != 256 or not all(v.all_valid() for v in verdicts):
        raise AssertionError("witness aggregate verify: a claim's verdict is false")
    _check_witness_shapes(distinct.blocks, device)
    return {
        "pairs": DIET_PAIRS,
        "witness_two_pass_bytes": two_pass,
        "witness_single_pass_bytes": single_pass,
        "witness_reduction_pct": 100.0 * (1.0 - two_pass / single_pass),
        "witness_bytes_per_proof": bytes_per_proof,
        "witness_delta_ratio": sum(ratios) / len(ratios),
        "delta_epochs": len(ratios),
        "witness_compressed_ratio": frame_ratio,
        "encodings": list(supported_encodings()),
        "aggregate_claims": len(verdicts),
        "aggregate_verify_ms": agg_ms,
        "per_claim_verify_ms": per_claim_ms,
        "launches": launches,
        "aggregate_launches": agg_launches,
    }


def _inclusion_ok(proof) -> bool:
    return verify_inclusion(
        bytes.fromhex(proof["leaf"]), proof["seq"], proof["size"],
        [bytes.fromhex(h) for h in proof["path"]], bytes.fromhex(proof["root"]),
    )


def registry_phase(device, root: str) -> dict:
    """The JAX bench.py registry leg's in-process half: a `ProofService`
    with ``registry_dir`` serves 96 generate requests, each response sealed
    (`encode_bundle_fields`, then `append_served` with its CID set);
    ``registry_append_overhead_pct`` is one append (2,048 timed) over one
    served request. Every record's inclusion proof verifies against the
    head, a consistency proof between two heads verifies, the head is the
    same after a reopen, and a 4-shard fleet directory resolves a sibling's
    base through `FleetBaseCache`."""
    reg_dir = os.path.join(root, "registry")
    store, pairs, _ = build_range_world(4, receipts_per_pair=12, events_per_receipt=2, match_rate=0.5)
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    service = ProofService(store=store, spec=spec, config=ServiceConfig(
        max_batch=8, max_wait_ms=2.0, workers=2, registry_dir=reg_dir, registry_owner="bench",
        device=_service_device(device),
    ))
    try:
        def serve(i):
            resp = service.generate(pairs[i % len(pairs)])
            fields = encode_bundle_fields(resp.bundle, WitnessOptions(), bases=service.witness_bases,
                                          metrics=service.metrics)
            service.registry.append_served(
                fields["digest"], verdict="served", key=f"pair:{i % len(pairs)}", trace=resp.trace_id,
                cids=resp.bundle.cid_set(),
            )
            return fields

        for i in range(len(pairs)):  # warm every pair through the batcher once
            serve(i)
        first = service.registry.head()
        _reset_counts()
        t0 = time.perf_counter()
        for i in range(REGISTRY_REQUESTS):
            serve(i)
        serve_mean_s = (time.perf_counter() - t0) / REGISTRY_REQUESTS
        launches = _counts()
        head = service.registry.head()
        if head["size"] != len(pairs) + REGISTRY_REQUESTS:
            raise AssertionError(f"registry: {head['size']} records for {len(pairs) + REGISTRY_REQUESTS} responses")
        proofs = [service.registry.inclusion_proof(seq) for seq in range(head["size"])]
        if not all(_inclusion_ok(p) and p["root"] == head["root"] for p in proofs):
            raise AssertionError("registry: an inclusion proof does not verify against the head")
        cons = service.registry.consistency(first["size"])
        if cons["old_root"] != first["root"] or not verify_consistency(
            cons["old_size"], cons["size"], bytes.fromhex(cons["old_root"]), bytes.fromhex(cons["root"]),
            [bytes.fromhex(h) for h in cons["path"]],
        ):
            raise AssertionError("registry: the consistency proof between two heads does not verify")
        health = service.health()
    finally:
        service.drain()
    reopened = ProvenanceRegistry(reg_dir, owner="bench")
    try:
        if reopened.head() != head:
            raise AssertionError(f"registry: head after reopen {reopened.head()} != {head}")
    finally:
        reopened.close()

    with tempfile.TemporaryDirectory(dir=root) as chain_dir:
        reg = ProvenanceRegistry(chain_dir, owner="bench")
        digests = [hashlib.sha256(f"append-{i}".encode()).hexdigest() for i in range(REGISTRY_APPENDS)]
        cid_sets = [frozenset(hashlib.sha256(f"{d}-{j}".encode()).digest() for j in range(3)) for d in digests]
        t0 = time.perf_counter()
        for i, (digest, cids) in enumerate(zip(digests, cid_sets)):
            reg.append_served(digest, trace=f"trace-{i}", tenant="bench", key=f"pair:{i % 8}",
                              verdict="served", cids=cids)
        append_mean_s = (time.perf_counter() - t0) / REGISTRY_APPENDS
        rng = random.Random(20260807)
        seqs = [rng.randrange(REGISTRY_APPENDS) for _ in range(200)]
        t0 = time.perf_counter()
        if not all(_inclusion_ok(reg.inclusion_proof(seq)) for seq in seqs):
            raise AssertionError("registry: an inclusion proof of the append chain does not verify")
        inclusion_ms = (time.perf_counter() - t0) * 1e3 / len(seqs)
        reg.close()

    with tempfile.TemporaryDirectory(dir=root) as fleet_dir:
        shards = [ProvenanceRegistry(fleet_dir, owner=f"shard-{s}") for s in range(REGISTRY_SHARDS)]
        try:
            for s, reg in enumerate(shards):
                reg.append_served(f"{s:064x}", key=f"filter:{s}", verdict="pushed",
                                  cids=frozenset({bytes([s]) * 36}), t=REGISTRY_T0 + s)
            metrics = Metrics()
            fleet = FleetBaseCache(WitnessBaseCache(), shards[0], metrics=metrics)
            # shard 0 served its own base (the local cache has it); the other
            # three come from the siblings' logs
            fleet.register(f"{0:064x}", frozenset({bytes([0]) * 36}))
            hits = [fleet.lookup(f"{s:064x}") == frozenset({bytes([s]) * 36}) for s in range(REGISTRY_SHARDS)]
            miss = fleet.lookup("ff" * 32)
        finally:
            for reg in shards:
                reg.close()
    if not all(hits) or miss is not None or metrics.counter_value("witness.fleet_base_hits") != REGISTRY_SHARDS - 1:
        raise AssertionError(f"registry: fleet lookups {hits}, miss {miss}, {metrics.snapshot()['counters']}")
    return {
        "requests": REGISTRY_REQUESTS,
        "records": head["size"],
        "serve_ms_per_request": serve_mean_s * 1e3,
        "registry_append_us": append_mean_s * 1e6,
        "registry_append_overhead_pct": 100.0 * append_mean_s / serve_mean_s,
        "registry_inclusion_proof_ms": inclusion_ms,
        "registry_chain_records": REGISTRY_APPENDS,
        "health": health["registry"],
        "log": reopened.path,
        "fleet_hits": sum(hits),
        "launches": launches,
    }


# --------------------------------------------------------------------------
# the HTTP plane: ProofHTTPServer, durable admission,
# replication, and `cli serve`, over loopback on the card
# --------------------------------------------------------------------------

# http generate reads the event world's first 256 pairs, cut from 4,096 to
# keep the script's time (the 4,096-pair phase took 61.8 s alone on one
# H100 80GB HBM3 at 700 W, 1,024 pairs 39.9 s)
HTTP_GENERATE_PAIRS = 256
REPLICA_PAIRS = COLD_PAIRS  # the cold read's pairs
HTTP_AGG_PAIRS = 16  # distinct pairs of the aggregated generate_range
HTTP_AGG_CLAIMS = 64  # claims over them (each pair claimed 4 times)
OVERLOAD_PAIRS = 4  # the JAX bench.py overload leg's world, uncut
OVERLOAD_RECEIPTS = 12
OVERLOAD_CAP_THREADS = 4
OVERLOAD_CAP_REQUESTS = 128
OVERLOAD_SECONDS = 4.0
DURABLE_GENERATES = 16
DURABLE_VERIFIES = 16
REPLICA_SEGMENT_BYTES = 1 << 16  # s0's segments roll often, so most of them replicate
CLI_SERVE_PAIRS = 256
CLI_SERVE_RANGE = CLI_SERVE_PAIRS  # the one bundle whose proofs the CLI daemon verifies


class _Clients:
    """HTTP/1.1 keep-alive connections to one daemon, one per calling
    thread; every connection is closed by `close`."""

    def __init__(self, port: int):
        self.port = port
        self._local = threading.local()
        self._lock = threading.Lock()
        self._all: list = []

    def request(self, method: str, path: str, body=None, headers=None):
        """(status, headers, raw body, ms to the response headers, ms to the
        last byte)."""
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        if isinstance(body, dict):
            body = json.dumps(body).encode()
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
            with self._lock:
                self._all.append(conn)
        t0 = time.perf_counter()
        conn.request(method, path, body, hdrs)
        resp = conn.getresponse()
        ttfb = time.perf_counter() - t0
        raw = resp.read()
        wall = time.perf_counter() - t0
        if resp.will_close or resp.getheader("Transfer-Encoding") == "chunked":
            # the daemon closes a connection after a stream (one stream a
            # connection) without saying so in a header
            conn.close()
            self._local.conn = None
        return resp.status, dict(resp.getheaders()), raw, ttfb * 1e3, wall * 1e3

    def close(self) -> None:
        with self._lock:
            for conn in self._all:
                conn.close()
            self._all.clear()


def _p99(values) -> "float | None":
    ordered = sorted(values)
    return ordered[max(0, int(len(ordered) * 0.99) - 1)] if ordered else None


def _ok_json(label: str, status: int, raw: bytes) -> dict:
    if status != 200:
        raise AssertionError(f"{label}: HTTP {status}: {raw[:300]!r}")
    return json.loads(raw)


def _remote_closed_loop(port: int, requests, clients: int) -> "tuple[list, float]":
    """`_closed_loop` of ``clients`` keep-alive threads over ``requests``
    ((method, path, body bytes) each) run from a child process, so the
    clients do not share the daemon's interpreter and GIL: (answers by
    index as `_Clients.request` gives them, wall seconds of the loop in
    the child)."""
    with tempfile.TemporaryDirectory() as work:
        spec, out = os.path.join(work, "requests.pickle"), os.path.join(work, "answers.pickle")
        with open(spec, "wb") as fh:
            pickle.dump({"port": port, "clients": clients, "requests": list(requests), "out": out}, fh)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--http-clients", spec],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"the HTTP client process exited {proc.returncode}: {proc.stderr[-3000:]}")
        with open(out, "rb") as fh:
            return pickle.load(fh)


def _http_clients_child(spec_path: str) -> None:
    """The child of `_remote_closed_loop`."""
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    clients = _Clients(spec["port"])
    requests = spec["requests"]
    try:
        result = _closed_loop(len(requests), spec["clients"], lambda i: clients.request(*requests[i]))
    finally:
        clients.close()
    with open(spec["out"], "wb") as fh:
        pickle.dump(result, fh)


def _blake2b_set(bundles) -> "dict[str, int]":
    """The blake2b launches of verifying each bundle with the witness CIDs
    on: one TxMeta batch each, plus one launch per size class present."""
    want = dict.fromkeys(SIZE_CLASSES, 0)
    for bundle in bundles:
        want["blake2b256_single_block"] += 1
        for name, rows in _classes(bundle.blocks).items():
            if rows:
                want[name] += 1
    return want


def http_verify_phase(device) -> dict:
    """Phase 17's stack behind `ProofHTTPServer`: 256 single-proof requests
    over the 768-event chain's bundle (996 blocks) from 32 clients in a
    child process, ``max_batch=32``, 4 ms window, 2 workers, CIDs off and on. Every answer
    is a 200 with the in-process service's verdicts for the same requests,
    and blake2b launches exactly one set a merged batch. Then one
    ``blocks_frame`` (zlib) request and one with a 256-claim ``claims``
    table, each one launch set and the in-process verdicts. Beside the HTTP
    rate: the handler's body parse alone on one thread, and the in-process
    rate over bundles parsed one a request."""
    backend = get_backend("gpu", device=device)
    svc_device = _service_device(device)
    world, slot = serve_chain()
    full = generate_proof_bundle(
        world.store, world.parent, world.child,
        [StorageProofSpec(actor_id=ACTOR_ID, slot=slot)],
        [EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)],
        match_backend=backend,
    )
    requests = [
        UnifiedProofBundle([], [full.event_proofs[i % SERVE_EVENTS]], full.blocks)
        for i in range(SERVE_REQUESTS)
    ]
    bodies = [json.dumps({"bundle": r.to_json_obj()}).encode() for r in requests]
    present = [name for name, rows in _classes(full.blocks).items() if rows]
    config = dict(max_batch=SERVE_CLIENTS, max_wait_ms=SERVE_WAIT_MS, queue_capacity=max(512, 2 * SERVE_REQUESTS),
                  workers=2, device=svc_device)

    # the in-process service on the same requests: the verdicts to match
    with ProofService(config=ServiceConfig(**config)) as service:
        for request in requests[:SERVE_CLIENTS]:  # warm
            service.verify(request)
        gc.collect()
        responses, inproc_wall = _closed_loop(SERVE_REQUESTS, SERVE_CLIENTS, lambda i: service.verify(requests[i]))
        inproc_batches = service.metrics.counter_value("serve.batches.verify")
    verdicts = [(r.storage_results, r.event_results) for r in responses]
    if verdicts != [([], [True])] * SERVE_REQUESTS:
        raise AssertionError("http verify: an in-process verdict is false")

    # the front end's share, taken apart: the handler's body parse alone
    # (json.loads + parse_bundle_obj, one thread), and the in-process
    # service over bundles parsed one a request, as the handler hands them
    # over (the loop above shares one witness object between requests)
    gc.collect()
    t0 = time.perf_counter()
    parsed = [parse_bundle_obj(json.loads(body)["bundle"]) for body in bodies]
    parse_ms = (time.perf_counter() - t0) * 1e3 / len(bodies)
    with ProofService(config=ServiceConfig(**config)) as service:
        for request in parsed[:SERVE_CLIENTS]:  # warm
            service.verify(request)
        gc.collect()
        responses, parsed_wall = _closed_loop(SERVE_REQUESTS, SERVE_CLIENTS, lambda i: service.verify(parsed[i]))
    if [(r.storage_results, r.event_results) for r in responses] != verdicts:
        raise AssertionError("http verify: the parsed bundles' in-process verdicts differ")
    del parsed

    runs = {}
    for cids in (False, True):
        label = "http verify, cids" if cids else "http verify"
        service = ProofService(config=ServiceConfig(verify_witness_cids=cids, **config))
        httpd = ProofHTTPServer(service).start()
        try:
            gc.collect()
            _reset_counts()
            answers, wall = _remote_closed_loop(
                httpd.port, [("POST", "/v1/verify", body) for body in bodies], SERVE_CLIENTS
            )
            torch.cuda.synchronize()
            launches = _counts()
            snap = service.metrics_snapshot()
        finally:
            httpd.shutdown(timeout=120)
        got = []
        for status, headers, raw, _, _ in answers:
            out = _ok_json(label, status, raw)
            if not headers.get("Server-Timing", "").startswith("queue;dur="):
                raise AssertionError(f"{label}: Server-Timing {headers.get('Server-Timing')}")
            got.append((out["storage_results"], out["event_results"]))
        if got != verdicts:
            raise AssertionError(f"{label}: verdicts differ from the in-process service's")
        batches = snap["counters"]["serve.batches.verify"]
        _require_launch_set(label, launches, _serve_launch_set(present if cids else [], batches, batches))
        latencies = [a[4] for a in answers]
        runs["cids" if cids else "plain"] = {
            "http_rps": SERVE_REQUESTS / wall,
            "wall_ms": wall * 1e3,
            "http_ms_per_request": sum(latencies) / len(latencies),
            "http_p99_ms": _p99(latencies),
            "server_p99_ms": snap.get("histograms", {}).get("serve.latency_ms.verify", {}).get("p99"),
            "mean_batch": snap.get("histograms", {}).get("serve.batch_size.verify", {}).get("mean"),
            "batches": batches,
            "launches": launches,
        }

    # one compressed-frame request and one 256-claim table, CIDs on
    agg = aggregate_range_bundle(
        full, [TipsetPair(world.parent, world.child)], [0], claim_indexes=[0] * SERVE_REQUESTS
    )
    framed = encode_bundle_fields(requests[1], WitnessOptions(encoding="zlib"))["bundle"]
    service = ProofService(config=ServiceConfig(verify_witness_cids=True, **dict(config, max_wait_ms=1.0)))
    httpd = ProofHTTPServer(service).start()
    clients = _Clients(httpd.port)
    extra = {}
    try:
        for name, body, bundle in (
            ("blocks_frame", {"bundle": framed}, requests[1]),
            ("claims", {"bundle": agg.bundle.to_json_obj(), "claims": agg.claims_json()}, agg.bundle),
        ):
            want = service.verify(bundle)
            _reset_counts()
            status, _, raw, _, ms = clients.request("POST", "/v1/verify", body)
            torch.cuda.synchronize()
            launches = _counts()
            out = _ok_json(f"http verify, {name}", status, raw)
            if (out["storage_results"], out["event_results"]) != (want.storage_results, want.event_results):
                raise AssertionError(f"http verify, {name}: verdicts differ from the in-process service's")
            if name == "claims":
                claims = out["claim_results"]
                if len(claims) != SERVE_REQUESTS or not all(c["all_valid"] for c in claims):
                    raise AssertionError("http verify, claims: a claim's verdict is false")
            _require_launch_set(f"http verify, {name}", launches, _serve_launch_set(present, 1, 1))
            extra[name] = {"ms": ms, "launches": launches, "all_valid": out["all_valid"]}
    finally:
        clients.close()
        httpd.shutdown(timeout=120)
    plain, cid_run = runs["plain"], runs["cids"]
    return {
        "requests": SERVE_REQUESTS,
        "clients": SERVE_CLIENTS,
        "witness_blocks": len(full.blocks),
        "inprocess_rps": SERVE_REQUESTS / inproc_wall,
        "inprocess_batches": inproc_batches,
        "parse_ms_per_request": parse_ms,
        "inprocess_parsed_rps": SERVE_REQUESTS / parsed_wall,
        "http_rps": plain["http_rps"],
        "http_rps_cids": cid_run["http_rps"],
        "http_ms_per_request": plain["http_ms_per_request"],
        "http_p99_ms": plain["http_p99_ms"],
        "runs": runs,
        "extra": extra,
        "launches": plain["launches"],
        "cids_launches": cid_run["launches"],
    }


def _witness_key(bundle) -> tuple:
    return tuple(b.cid.to_bytes() for b in bundle.blocks)


def http_generate_phase(world, device, root: str) -> dict:
    """The event world's first `HTTP_GENERATE_PAIRS` pairs through ``/v1/generate``, one pair a
    request from 32 clients, against a daemon with a disk tier: buffered
    JSON first (it warms the disk), then the IPBS stream, whose blocks must
    all go out as frame slices (``warm_block_bytes_copied_per_resp`` 0).
    Each answer's event proofs equal generating its pair alone; each
    batch's witness verifies its claims on the card (one launch set a
    batch); one aggregated ``/v1/generate_range`` over repeated pair indexes
    equals the in-process service's fields."""
    store, pairs, _ = world
    pairs = pairs[:HTTP_GENERATE_PAIRS]
    backend = get_backend("gpu", device=device)
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    # each pair's proofs alone: the range's proofs grouped by parent epoch
    # (every pair has its own parent height)
    solo = {pair.parent.height: [] for pair in pairs}
    for proof in generate_event_proofs_for_range(store, pairs, spec, match_backend=backend).event_proofs:
        solo[proof.parent_epoch].append(proof.to_json_obj())
    solo = [solo[pair.parent.height] for pair in pairs]
    service = ProofService(store=store, spec=spec, config=ServiceConfig(
        max_batch=SERVE_CLIENTS, max_wait_ms=SERVE_WAIT_MS, queue_capacity=2 * len(pairs), workers=2,
        store_dir=os.path.join(root, "http-generate"), device=_service_device(device),
    ))
    httpd = ProofHTTPServer(service, pairs=pairs).start()
    clients = _Clients(httpd.port)
    runs = {}
    try:
        for mode in ("buffered", "stream"):
            body = {"stream": True} if mode == "stream" else {}
            snap0 = service.metrics_snapshot()
            gc.collect()
            _reset_counts()
            answers, wall = _remote_closed_loop(httpd.port, [
                ("POST", "/v1/generate", json.dumps(dict(body, pair_index=i)).encode()) for i in range(len(pairs))
            ], SERVE_CLIENTS)
            torch.cuda.synchronize()
            launches = _counts()
            snap1 = service.metrics_snapshot()
            c0, c1 = snap0["counters"], snap1["counters"]
            bundles = []
            for i, (status, headers, raw, _, _) in enumerate(answers):
                if status != 200:
                    raise AssertionError(f"http generate ({mode}): HTTP {status}: {raw[:300]!r}")
                if mode == "stream":
                    if headers.get("Content-Type") != "application/x-ipc-bundle-stream":
                        raise AssertionError(f"http generate (stream): Content-Type {headers.get('Content-Type')}")
                    doc = decode_bundle_stream(raw)
                else:
                    doc = json.loads(raw)
                if headers.get("Witness-Encoding") != "identity" or doc["n_event_proofs"] != len(solo[i]):
                    raise AssertionError(f"http generate ({mode}): pair {i}'s header or count")
                bundle = UnifiedProofBundle.from_json_obj(doc["bundle"])
                if [p.to_json_obj() for p in bundle.event_proofs] != solo[i]:
                    raise AssertionError(f"http generate ({mode}): pair {i} differs from generating it alone")
                bundles.append(bundle)
            delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
                "serve.batches.generate", "serve.stream.zero_copy_bytes", "serve.stream.copied_bytes",
                "serve.stream.responses", "storex.slice_hits",
            )}
            # over the disk tier the scan is the Python walk: one flat event
            # mask a chunk of a batch (range_chunk_size pairs), no other kernel
            chunks = (snap1["timers"]["range_match"]["calls"]
                      - snap0.get("timers", {}).get("range_match", {}).get("calls", 0))
            delta["chunks"] = chunks
            want = dict.fromkeys(launches, 0)
            want["event_match_mask"] = chunks
            if launches != want:
                raise AssertionError(f"http generate ({mode}): launches {launches}, expected {want}")
            runs[mode] = {
                "pairs_per_s": len(pairs) / wall,
                "wall_ms": wall * 1e3,
                "http_ms_per_request": sum(a[4] for a in answers) / len(answers),
                "http_p99_ms": _p99([a[4] for a in answers]),
                "ttfb_ms": sum(a[3] for a in answers) / len(answers),
                "bytes_per_response": sum(len(a[2]) for a in answers) / len(answers),
                "counters": delta,
                "launches": launches,
                "bundles": bundles,
            }
        stream = runs["stream"]["counters"]
        copied_per_resp = stream["serve.stream.copied_bytes"] / len(pairs)
        if stream["serve.stream.responses"] != len(pairs) or copied_per_resp != 0 or not stream[
            "serve.stream.zero_copy_bytes"
        ]:
            raise AssertionError(f"http generate (stream): warm responses copied block bytes: {stream}")

        # an aggregated range over repeated pair indexes
        idxs = [i % HTTP_AGG_PAIRS for i in range(HTTP_AGG_CLAIMS)]
        status, _, raw, _, agg_ms = clients.request(
            "POST", "/v1/generate_range", {"pair_indexes": idxs, "aggregate": True}
        )
        got = _ok_json("http generate_range, aggregate", status, raw)
        distinct = service.generate_range([pairs[i] for i in range(HTTP_AGG_PAIRS)])
        claims = aggregate_range_bundle(distinct, pairs, list(range(HTTP_AGG_PAIRS)), claim_indexes=idxs).claims_json()
        want = dict(encode_bundle_fields(distinct, WitnessOptions(), claims=claims),
                    n_event_proofs=len(distinct.event_proofs), n_pairs=HTTP_AGG_PAIRS)
        if got != want:
            raise AssertionError("http generate_range, aggregate: the answer differs from the in-process fields")
    finally:
        clients.close()
        httpd.shutdown(timeout=120)

    # each batch's shared witness verifies its claims on the card
    groups: "dict[tuple, UnifiedProofBundle]" = {}
    for bundle in runs["buffered"].pop("bundles") + runs["stream"].pop("bundles"):
        group = groups.setdefault(_witness_key(bundle), UnifiedProofBundle([], [], bundle.blocks))
        group.event_proofs.extend(bundle.event_proofs)
    verified = [g for g in groups.values() if g.event_proofs]
    gc.collect()
    _reset_counts()
    for group in verified:
        if not verify_proof_bundle(group, TrustPolicy.accept_all(), verify_witness_cids=True,
                                   cid_backend=backend).all_valid():
            raise AssertionError("http generate: a served claim does not verify over its batch's witness")
    torch.cuda.synchronize()
    verify_launches = _counts()
    _require_launch_set("http generate, verify", verify_launches, _blake2b_set(verified))
    served = sum(len(g.event_proofs) for g in verified)
    if served != 2 * sum(len(proofs) for proofs in solo):
        raise AssertionError(f"http generate: {served} proofs served twice over for {len(solo)} pairs")
    return {
        "pairs": len(pairs),
        "runs": runs,
        "warm_block_bytes_copied_per_resp": copied_per_resp,
        "stream_ttfb_ms": runs["stream"]["ttfb_ms"],
        "aggregate_ms": agg_ms,
        "verified_batches": len(verified),
        "launches": runs["buffered"]["launches"],
        "stream_launches": runs["stream"]["launches"],
        "verify_launches": verify_launches,
    }


def http_overload_phase(device) -> dict:
    """The JAX bench.py overload leg's stack, uncut, on the card: a daemon
    with ``admit_gradient`` (initial limit 8, 75 ms delay budget, tenant
    weight interactive=4) over the 4-pair world; capacity from 4 closed-loop
    clients over 128 requests, then 4 s at twice the clients with a light
    named tenant and a stream of tight-deadline requests. Every answer is a
    200, a typed 429 or a typed 504; the four meters are recorded, not
    gated."""
    store, pairs, _ = build_range_world(
        OVERLOAD_PAIRS, receipts_per_pair=OVERLOAD_RECEIPTS, events_per_receipt=2, match_rate=0.5,
        signature=SIGNATURE, topic1=TOPIC1, actor_id=ACTOR_ID,
    )
    service = ProofService(store=store, spec=EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID), config=ServiceConfig(
        max_batch=8, max_wait_ms=2.0, workers=2, admit_gradient=True, admit_initial=8,
        admit_delay_budget_ms=75.0, tenant_weights={"interactive": 4}, device=_service_device(device),
    ))
    httpd = ProofHTTPServer(service, pairs=pairs).start()
    clients = _Clients(httpd.port)
    untyped: list = []

    def post(obj, headers=None):
        status, _, raw, _, ms = clients.request("POST", "/v1/generate", obj, headers)
        if status not in (200, 429, 504):
            untyped.append((status, raw[:200]))
        elif status != 200 and json.loads(raw).get("error_type") not in ("admit_rejected", "tenant_throttled",
                                                                          "deadline", "cancelled"):
            untyped.append((status, raw[:200]))
        return status, raw, ms

    try:
        for i in range(OVERLOAD_PAIRS):
            if post({"pair_index": i})[0] != 200:
                raise AssertionError("http overload: a warm request failed")
        _reset_counts()
        _, cap_wall = _closed_loop(OVERLOAD_CAP_REQUESTS, OVERLOAD_CAP_THREADS,
                                   lambda i: post({"pair_index": i % OVERLOAD_PAIRS}))
        capacity_rps = OVERLOAD_CAP_REQUESTS / cap_wall
        c0 = service.metrics_snapshot()["counters"]
        stop = threading.Event()
        tally = {200: 0, 429: 0, "other": 0}
        lock = threading.Lock()
        light_ms: list = []
        doomed = [0]

        def heavy():
            while not stop.is_set():
                status, raw, _ = post({"pair_index": 0})
                with lock:
                    tally[status if status in tally else "other"] += 1
                if status == 429:
                    stop.wait(min(float(json.loads(raw).get("retry_after_s", 0.05)), 0.05))

        def light():
            while not stop.is_set():
                status, _, ms = post({"pair_index": 1 % OVERLOAD_PAIRS}, {"X-IPC-Tenant": "interactive"})
                if status == 200:
                    light_ms.append(ms)
                stop.wait(0.02)

        def doomed_client():
            n = 0
            while not stop.is_set():
                post({"pair_index": 0, "deadline_ms": 1 if n % 2 == 0 else 15})
                doomed[0] += 1
                n += 1
                stop.wait(0.03)

        threads = [threading.Thread(target=heavy) for _ in range(2 * OVERLOAD_CAP_THREADS)]
        threads += [threading.Thread(target=light), threading.Thread(target=doomed_client)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(OVERLOAD_SECONDS)
        stop.set()
        for t in threads:
            t.join(120)
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _counts()
        snap = service.metrics_snapshot()
    finally:
        clients.close()
        httpd.shutdown(timeout=120)
    if untyped or any(t.is_alive() for t in threads):
        raise AssertionError(f"http overload: untyped answers {untyped[:5]}")
    if any(launches.values()):  # the fused C scan over the in-memory world matches on the host
        raise AssertionError(f"http overload: generation launched {launches}")
    if not light_ms:
        raise AssertionError("http overload: the light tenant got no answer")
    c1 = snap["counters"]
    answered = sum(tally.values())
    reclaimed = (c1.get("serve.deadline_rejects", 0) - c0.get("serve.deadline_rejects", 0)
                 + c1.get("serve.cancelled_inflight", 0) - c0.get("serve.cancelled_inflight", 0))
    return {
        "capacity_rps": capacity_rps,
        "goodput_rps": tally[200] / elapsed,
        "goodput_ratio_at_2x": tally[200] / elapsed / capacity_rps,
        "shed_rate": tally[429] / answered if answered else None,
        "light_tenant_p99_ms_overload": _p99(light_ms),
        "cancel_reclaim_pct": 100.0 * min(1.0, reclaimed / doomed[0]) if doomed[0] else None,
        "answers": {str(k): v for k, v in tally.items()},
        "admit_limit": snap.get("gauges", {}).get("admit.limit"),
        "batches": c1.get("serve.batches.generate", 0),
        "launches": launches,
    }


def durable_phase(world, device, root: str) -> dict:
    """`DurableAdmission` behind the daemon, as ``serve --queue-dir`` wires
    it, CIDs on: 16 generate and 16 verify requests are admitted (their
    admit records fsync'd) while the batcher holds them; the server is
    aborted and the queue's journal closed with that work pending. A fresh
    service reopens the same directory: every pending admit re-executes on
    the card (its verify launch sets counted), and each result equals a
    clean run of the same request; an ``idempotency_key`` retry over HTTP
    comes back ``cached``."""
    store, pairs, _ = world
    chain, slot = serve_chain()
    full = generate_proof_bundle(
        chain.store, chain.parent, chain.child, [StorageProofSpec(actor_id=ACTOR_ID, slot=slot)],
        [EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)], match_backend=get_backend("gpu", device=device),
    )
    verifies = [UnifiedProofBundle([], [full.event_proofs[i]], full.blocks) for i in range(DURABLE_VERIFIES)]
    work = [("generate", i * 97 % len(pairs)) for i in range(DURABLE_GENERATES)]
    work += [("verify", b.to_json_obj()) for b in verifies]
    queue_dir = os.path.join(root, "queue")
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)

    def service(wait_ms):
        return ProofService(store=store, spec=spec, config=ServiceConfig(
            max_batch=4 * len(work), max_wait_ms=wait_ms, workers=2, verify_witness_cids=True,
            queue_capacity=4 * len(work), device=_service_device(device),
        ))

    # admit everything while a 60 s window holds the batch, then crash
    held = service(60_000.0)
    durable = DurableAdmission(held, queue_dir, pairs=pairs)
    httpd = ProofHTTPServer(held, pairs=pairs, durable=durable).start()
    clients = _Clients(httpd.port)
    answers: list = []

    def client(i):
        kind, payload = work[i]
        body = {"pair_index": payload} if kind == "generate" else {"bundle": payload}
        try:
            answers.append(clients.request("POST", f"/v1/{kind}", dict(body, idempotency_key=f"k{i}"))[0])
        except (OSError, http.client.HTTPException) as exc:  # the crash may cut a connection
            answers.append(type(exc).__name__)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(work))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    admits = 0
    while time.monotonic() < deadline:
        records, _, _ = read_journal(os.path.join(queue_dir, QUEUE_JOURNAL_NAME))
        admits = sum(1 for r in records if r["t"] == "admit")
        if admits == len(work):
            break
        time.sleep(0.01)
    httpd.abort()
    durable.close()  # the process dies: nothing it does later reaches the journal
    held.drain(timeout=300)
    for t in threads:
        t.join(120)
    clients.close()
    records, _, _ = read_journal(os.path.join(queue_dir, QUEUE_JOURNAL_NAME))
    done_before = sum(1 for r in records if r["t"] == "done")
    if admits != len(work) or done_before:
        raise AssertionError(f"durable: {admits} admits and {done_before} done records at the crash")

    # a clean run of the same requests, one at a time (a replay runs each
    # admit alone, so its batches are of one)
    with tempfile.TemporaryDirectory(dir=root) as clean_dir:
        clean_svc = service(1.0)
        clean = DurableAdmission(clean_svc, clean_dir, pairs=pairs)
        try:
            expected = [clean.submit(kind, payload)[1] for kind, payload in work]
        finally:
            clean.close()
            clean_svc.drain()

    fresh = service(1.0)
    gc.collect()
    _reset_counts()
    t0 = time.perf_counter()
    reopened = DurableAdmission(fresh, queue_dir, pairs=pairs)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    httpd = ProofHTTPServer(fresh, pairs=pairs, durable=reopened).start()
    clients = _Clients(httpd.port)
    try:
        if reopened.resumed_jobs != len(work):
            raise AssertionError(f"durable: resumed_jobs {reopened.resumed_jobs}, expected {len(work)}")
        _require_launch_set("durable replay", launches, _blake2b_set(verifies))
        drop = ("trace_id", "server_timing")
        for i, ((kind, payload), want) in enumerate(zip(work, expected)):
            _, got, cached = reopened.submit(kind, payload, idempotency_key=f"k{i}")
            if not cached or {k: v for k, v in got["result"].items() if k not in drop} != {
                k: v for k, v in want["result"].items() if k not in drop
            }:
                raise AssertionError(f"durable: request {i} ({kind}) differs from a clean run")
        kind, payload = work[-1]
        status, _, raw, _, _ = clients.request("POST", "/v1/verify", {"bundle": payload, "idempotency_key": f"k{len(work) - 1}"})
        retry = _ok_json("durable retry", status, raw)
        if retry["cached"] is not True or retry["result"]["all_valid"] is not True:
            raise AssertionError(f"durable: the idempotent retry came back {retry.get('cached')}")
        status, _, raw, _, _ = clients.request("GET", "/healthz")
        health = _ok_json("durable healthz", status, raw)
    finally:
        clients.close()
        httpd.shutdown(timeout=120)
    return {
        "admitted": admits,
        "answers_before_crash": {str(a): answers.count(a) for a in set(answers)},
        "resumed_jobs": reopened.resumed_jobs,
        "replay_ms": replay_ms,
        "journal_bytes": health["journal_bytes"],
        "launches": launches,
    }


def replication_phase(world, device, root: str) -> dict:
    """Two daemons with disk tiers, owners ``s0`` and ``s1``. ``s0`` is
    warmed over HTTP with generate over the cold read's `COLD_PAIRS` pairs; ``POST
    /v1/replicate`` on ``s1`` pulls s0's rolled segments; every ingested
    block is read back on ``s1`` through ``get_many``: one lane call on the
    card (``IPC_VERIFY_MIN_BYTES=0``). A forged frame on ``s1`` repairs from
    ``s0`` (``storex.replica_repairs`` 1), and a generate on ``s1`` then
    reads nothing from its inner store."""
    store, pairs, _ = world
    pairs = pairs[:REPLICA_PAIRS]
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)

    class Counted:
        """The inner store, counting reads (a read-repair that reaches it,
        or a generate on s1 that does, is the failure)."""

        def __init__(self, inner):
            self.inner, self.gets = inner, 0

        def get(self, cid):
            self.gets += 1
            return self.inner.get(cid)

        def put_keyed(self, cid, data):
            self.inner.put_keyed(cid, data)

        def has(self, cid):
            return self.inner.has(cid)

    shards = {}
    for owner in ("s0", "s1"):
        inner = Counted(store)
        svc = ProofService(store=inner, spec=spec, config=ServiceConfig(
            max_batch=SERVE_CLIENTS, max_wait_ms=SERVE_WAIT_MS, workers=2, store_dir=os.path.join(root, owner),
            store_owner=owner, store_segment_max_bytes=REPLICA_SEGMENT_BYTES, device=_service_device(device),
        ))
        shards[owner] = (ProofHTTPServer(svc, pairs=pairs).start(), svc, inner)
    (s0, svc0, _), (s1, svc1, inner1) = shards["s0"], shards["s1"]
    clients0, clients1 = _Clients(s0.port), _Clients(s1.port)
    try:
        t0 = time.perf_counter()
        answers, _ = _closed_loop(len(pairs), SERVE_CLIENTS,
                                  lambda i: clients0.request("POST", "/v1/generate", {"pair_index": i}))
        warm_ms = (time.perf_counter() - t0) * 1e3
        for status, _, raw, _, _ in answers:
            _ok_json("replication warm", status, raw)
        source = {"name": "s0", "url": s0.address}
        t0 = time.perf_counter()
        status, _, raw, _, _ = clients1.request("POST", "/v1/replicate", {"sources": [source]})
        pull_ms = (time.perf_counter() - t0) * 1e3
        pulled = _ok_json("replicate", status, raw)
        if not pulled["pulled"] or pulled["errors"]:
            raise AssertionError(f"replication: pulled {pulled}")
        status, _, raw, _, _ = clients1.request("POST", "/v1/replica_peers", {"peers": [source]})
        _ok_json("replica_peers", status, raw)

        disk1 = svc1.disk_store
        ingested = [s["name"] for s in disk1.segment_files() if s["owner"] == "s0"]
        frames = [f for f in _frames(os.path.join(root, "s1")) if os.path.basename(f[0]) in ingested]
        cids = [CID.from_bytes(raw_cid) for _, _, _, raw_cid in frames]
        with _env("IPC_VERIFY_MIN_BYTES", "0"), _verify_calls(segments_mod) as calls:
            gc.collect()
            _reset_counts()
            t0 = time.perf_counter()
            got = disk1.get_many(cids)
            torch.cuda.synchronize()
            get_many_ms = (time.perf_counter() - t0) * 1e3
            get_many_launches = _counts()
        if len(got) != len(cids) or len(calls) != 1:
            raise AssertionError(f"replication: get_many gave {len(got)} of {len(cids)} in {len(calls)} lane calls")
        present = {size_class(len(data)) for data in got.values()}
        _require_launch_set("replica get_many", get_many_launches,
                            {name: int(name in present) for name in SIZE_CLASSES})
        if any(got[c] != store.get(c) for c in cids):
            raise AssertionError("replication: an ingested block differs from the world's")

        # forge one ingested frame of pair 0's witness; its read repairs from s0
        witness = {b.cid.to_bytes() for b in generate_event_proofs_for_range(
            store, pairs[:1], spec, match_backend=get_backend("gpu", device=device)).blocks}
        victim = next(f for f in frames if f[3] in witness)
        _forge(*victim[:3])
        repairs0 = svc1.metrics.counter_value("storex.replica_repairs")
        cid = CID.from_bytes(victim[3])
        if svc1.blockstore.get(cid) != store.get(cid):
            raise AssertionError("replication: the forged frame did not read back repaired")
        repairs = svc1.metrics.counter_value("storex.replica_repairs") - repairs0
        gets0 = inner1.gets
        status, _, raw, _, _ = clients1.request("POST", "/v1/generate", {"pair_index": 0})
        out = _ok_json("replication generate on s1", status, raw)
        inner_reads = inner1.gets - gets0
        if repairs != 1 or inner_reads:
            raise AssertionError(f"replication: {repairs} repairs, {inner_reads} inner-store reads")
        if [p["event_data"] for p in out["bundle"]["event_proofs"]] != [
            p.event_data.to_json_obj() for p in generate_event_proofs_for_range(
                store, pairs[:1], spec, match_backend=get_backend("gpu", device=device)).event_proofs
        ]:
            raise AssertionError("replication: s1's generate differs from the in-memory one")
    finally:
        clients0.close()
        clients1.close()
        for httpd, _, _ in shards.values():
            httpd.shutdown(timeout=120)
    return {
        "pairs": len(pairs),
        "warm_ms": warm_ms,
        "segments_pulled": pulled["pulled"],
        "bytes_pulled": pulled["bytes"],
        "blocks_pulled": pulled["blocks"],
        "pending": pulled["pending"],
        "pull_ms": pull_ms,
        "get_many_blocks": len(cids),
        "get_many_ms": get_many_ms,
        "replica_repairs": repairs,
        "inner_reads_after_repair": inner_reads,
        "launches": get_many_launches,
    }


def cli_serve_phase(device, root: str) -> dict:
    """``python -m ipc_proofs_tpu_torch.cli serve --demo-world 256
    --check-cids`` with a disk tier, a durable queue and a registry, as a
    user starts it: every pair generated, then the whole world's bundle's proofs
    verified one a request from 32 clients; ``/metrics``, ``/metrics.prom``
    and ``/healthz`` read; an inclusion proof checked against the head.
    SIGTERM: exit 0, and every admitted request has its done record. The
    kernel launches are the daemon's own: its wrappers' counts, which it
    logs once serving starts and again after the drain. Their difference
    must be one TxMeta batch a merged verify batch plus one launch a size
    class of the witness (blake2b), and one flat event mask a chunk of a
    generate batch (the ``range_match`` timer's calls), nothing else."""
    work = os.path.join(root, "cli-serve")
    os.makedirs(work, exist_ok=True)
    port_file = os.path.join(work, "port")
    argv = [sys.executable, "-m", "ipc_proofs_tpu_torch.cli", "serve", "--demo-world", str(CLI_SERVE_PAIRS),
            "--check-cids", "--port", "0", "--port-file", port_file, "--store-dir", os.path.join(work, "seg"),
            "--queue-dir", os.path.join(work, "queue"), "--registry-dir", os.path.join(work, "reg")]
    if torch.device(device).type != "cuda":  # a run of the phase on the CPU
        argv += ["--backend", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    clients = None
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(port_file) and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if not os.path.exists(port_file):
            raise AssertionError(f"cli serve did not come up: {proc.poll()}")
        start_ms = (time.perf_counter() - t0) * 1e3
        with open(port_file) as fh:
            clients = _Clients(int(fh.read()))
        t0 = time.perf_counter()
        answers, gen_wall = _closed_loop(CLI_SERVE_PAIRS, SERVE_CLIENTS,
                                         lambda i: clients.request("POST", "/v1/generate", {"pair_index": i}))
        for status, _, raw, _, _ in answers:
            if not _ok_json("cli serve generate", status, raw)["ok"]:
                raise AssertionError(f"cli serve generate: {raw[:300]!r}")
        status, _, raw, _, _ = clients.request("POST", "/v1/generate_range",
                                               {"pair_indexes": list(range(CLI_SERVE_RANGE))})
        bundle = UnifiedProofBundle.from_json_obj(_ok_json("cli serve range", status, raw)["result"]["bundle"])
        requests = [UnifiedProofBundle([], [p], bundle.blocks).to_json_obj() for p in bundle.event_proofs]
        answers, verify_wall = _closed_loop(len(requests), SERVE_CLIENTS,
                                            lambda i: clients.request("POST", "/v1/verify", {"bundle": requests[i]}))
        for status, _, raw, _, _ in answers:
            if _ok_json("cli serve verify", status, raw)["result"]["all_valid"] is not True:
                raise AssertionError("cli serve verify: a verdict is false")
        status, _, raw, _, _ = clients.request("GET", "/metrics")
        snap = _ok_json("cli serve metrics", status, raw)
        status, headers, prom, _, _ = clients.request("GET", "/metrics.prom")
        if status != 200 or b"ipc_serve_batches_verify_total" not in prom:
            raise AssertionError(f"cli serve metrics.prom: HTTP {status}")
        status, _, raw, _, _ = clients.request("GET", "/healthz")
        health = _ok_json("cli serve healthz", status, raw)
        status, _, raw, _, _ = clients.request("GET", "/v1/registry/head")
        head = _ok_json("cli serve registry head", status, raw)
        status, _, raw, _, _ = clients.request("GET", f"/v1/registry/proof?seq={head['size'] // 2}")
        proof = _ok_json("cli serve registry proof", status, raw)
        if proof["root"] != head["root"] or not _inclusion_ok(proof):
            raise AssertionError("cli serve: the registry's inclusion proof does not verify against its head")
    finally:
        if clients is not None:
            clients.close()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"cli serve exited {proc.returncode}: {err[-3000:]}")
    records, _, torn = read_journal(os.path.join(work, "queue", QUEUE_JOURNAL_NAME))
    admitted = {r["key"] for r in records if r["t"] == "admit"}
    finished = {r["key"] for r in records if r["t"] == "done"}
    if torn or admitted != finished or len(admitted) != CLI_SERVE_PAIRS + 1 + len(requests):
        raise AssertionError(f"cli serve: {len(admitted)} admitted, {len(admitted - finished)} without a result")
    logged = [json.loads(line.split("kernel launches: ", 1)[1]) for line in err.splitlines()
              if "kernel launches: " in line]
    if len(logged) != 2:
        raise AssertionError(f"cli serve logged {len(logged)} kernel launch lines, expected 2: {err[-3000:]}")
    started, drained = logged
    launches = {name: drained[name] - started[name] for name in drained}
    counters = snap["counters"]
    batches = counters["serve.batches.verify"]
    present = [name for name, rows in _classes(bundle.blocks).items() if rows]
    want = dict.fromkeys(launches, 0)
    if torch.device(device).type == "cuda":  # `--backend cpu` launches nothing
        want.update(_serve_launch_set(present, batches, batches))
        want["event_match_mask"] = snap["timers"]["range_match"]["calls"]
    if launches != want:
        raise AssertionError(f"cli serve: the daemon launched {launches}, expected {want}")
    return {
        "pairs": CLI_SERVE_PAIRS,
        "start_ms": start_ms,
        "generate_rps": CLI_SERVE_PAIRS / gen_wall,
        "verify_requests": len(requests),
        "verify_rps": len(requests) / verify_wall,
        "serve.batches.verify": batches,
        "serve.batches.generate": counters.get("serve.batches.generate"),
        "registry_size": head["size"],
        "health": health["status"],
        "exit": proc.returncode,
        "startup_launches": started,
        "launches": launches,
    }


# --------------------------------------------------------------------------
# standing queries, the SLO watchdog and backfill, over the event world
# --------------------------------------------------------------------------

SUBS_TIPSETS = 128  # finalized by the follower: the first 64 pairs' two heights each
SUBS_RETRY = (3, 0.002, 0.008)  # webhook attempts, backoff base and cap (s)
BACKFILL_WINDOW = 8
BACKFILL_KILL_AT = 128  # windows committed before the first engine is closed
CLI_BACKFILL_PAIRS = 64
CLI_BACKFILL_WINDOW = 8


def _subscriptions() -> "list[dict]":
    """64 subscriptions over 12 distinct filters: 24 on (signature, topic1)
    (16 webhooks, 8 long-poll), 16 on the contract's events (8 webhooks, 4
    webhooks whose endpoint is down in the first life, 4 long-poll), 16 on
    eight actor filters nothing in the world emits (webhooks), and 8 with
    a storage leg: the contract's topdown nonce slot or a slot it does not
    hold (webhooks)."""
    base = {"signature": SIGNATURE, "topic1": TOPIC1}
    subs = []

    def add(filt, mode):
        i = len(subs)
        body = {"filter": filt, "sub_id": f"sub-{i:02d}"}
        if mode != "poll":
            body["target"] = {"url": f"WEBHOOK/{mode}/{i:02d}"}
        subs.append(body)

    for i in range(24):
        add(dict(base), "up" if i < 16 else "poll")
    for i in range(16):
        add(dict(base, actor_id=ACTOR_ID), "up" if i < 8 else ("down" if i < 12 else "poll"))
    for i in range(16):
        add(dict(base, actor_id=2001 + i // 2), "up")
    for i in range(8):
        slot = calculate_storage_slot(TOPIC1, 0) if i < 4 else b"\x5a" * 32
        add(dict(base, actor_id=ACTOR_ID, slot=slot.hex()), "up")
    return subs


class _WebhookHandler(http.server.BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
        down = self.path.startswith("/down/") and os.path.exists(self.server.down_flag)
        status = 503 if down else 200
        with self.server.lock:
            with open(self.server.log_path, "a") as fh:
                fh.write(json.dumps({"path": self.path, "status": status, "body": body.decode()}) + "\n")
        self.send_response(status)
        self.send_header("Content-Length", "0")
        self.end_headers()


def _webhook_receiver_child(work: str) -> None:
    """The webhook endpoint of the standing-query phase, in a process of
    its own: every POST is logged to ``work/posts.jsonl``; a path under
    ``/down/`` answers 503 while ``work/down`` exists, anything else 200."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _WebhookHandler)
    server.lock = threading.Lock()
    server.log_path = os.path.join(work, "posts.jsonl")
    server.down_flag = os.path.join(work, "down")
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(target=server.shutdown).start())
    with open(os.path.join(work, "port.tmp"), "w") as fh:
        fh.write(str(server.server_address[1]))
    os.replace(os.path.join(work, "port.tmp"), os.path.join(work, "port"))
    server.serve_forever()
    server.server_close()


@contextlib.contextmanager
def _webhook_receiver(work: str):
    """(base URL, posts reader) of a receiver child; stopped on exit."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--webhook-receiver", work])
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(os.path.join(work, "port")):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"the webhook receiver did not start (exit {proc.poll()})")
            time.sleep(0.05)
        with open(os.path.join(work, "port")) as fh:
            port = int(fh.read())

        def posts() -> "list[dict]":
            path = os.path.join(work, "posts.jsonl")
            if not os.path.exists(path):
                return []
            with open(path) as fh:
                return [json.loads(line) for line in fh if line.endswith("\n")]

        yield f"http://127.0.0.1:{port}", posts
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _call_json(clients, label: str, method: str, path: str, body=None) -> dict:
    """One request through ``clients``; the parsed JSON of a 200, else a
    failure naming ``label``."""
    status, _, raw, _, _ = clients.request(method, path, body)
    return _ok_json(label, status, raw)


def _wait_for(label: str, cond, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: timed out")
        time.sleep(0.01)


def _standing(root: str, service):
    """`StandingQueries` over ``root/subs`` riding ``service``'s PUSH lane
    (delta on; webhook backoff in milliseconds)."""
    from ipc_proofs_tpu_torch.subs import StandingQueries

    attempts, base_s, max_s = SUBS_RETRY
    return StandingQueries(
        os.path.join(root, "subs"), store=service.blockstore, metrics=service.metrics, chunk_size=8,
        match_backend=service.match_backend, retry_attempts=attempts, retry_base_s=base_s, retry_max_s=max_s,
        delta=True, service=service, provenance=service.registry,
    )


def subs_phase(world, device, root: str) -> dict:
    """Standing queries over the 4,096-pair event world, behind
    `ProofHTTPServer` with the SLO watchdog on: 64 subscriptions posted
    over HTTP (`_subscriptions`), webhooks to a receiver child process; a
    `ChainFollower` over the hermetic node finalizes `SUBS_TIPSETS`, each
    matched on the service's PUSH lane with the scan unfused (the event
    mask on the card): one generation per distinct (pair, filter), every
    push's digest and bundle (expanded when it is a delta) equal to the
    chunked driver's for its pair and filter, the storage-leg filters
    failing as in the reference (``subs.errors``, nothing delivered); the
    long-poll cursors and acks; every delivered bundle verified on the card;
    ``/healthz`` with the subs fields and the ``slo`` block; then a restart
    over the same directory replays the registry and re-pushes every
    delivery the down endpoint refused, the same bytes."""
    from ipc_proofs_tpu_torch.obs.slo import SloWatchdog
    from ipc_proofs_tpu_torch.subs import filter_key, normalize_filter

    store, pairs, _ = world
    backend = get_backend("gpu", device=device)
    spec = EventProofSpec(SIGNATURE, TOPIC1)
    subs = _subscriptions()
    fed_pairs = pairs[: SUBS_TIPSETS // 2]
    tipsets = [ts for pair in fed_pairs for ts in (pair.parent, pair.child)]
    work = os.path.join(root, "webhook")
    os.makedirs(work)
    open(os.path.join(work, "down"), "w").close()
    svc_cfg = dict(max_batch=SERVE_CLIENTS, max_wait_ms=SERVE_WAIT_MS, workers=2, device=_service_device(device))
    with _webhook_receiver(work) as (hook, posts), _env("IPC_SCAN_FUSED_MATCH", "0"):
        for body in subs:
            if "target" in body:
                body["target"]["url"] = body["target"]["url"].replace("WEBHOOK", hook)
        service = ProofService(store=store, spec=spec, config=ServiceConfig(**svc_cfg))
        sq = _standing(root, service)
        slo = SloWatchdog(metrics=service.metrics, interval_s=0.25)
        slo.start()
        httpd = ProofHTTPServer(service, pairs=pairs, subs=sq, slo=slo).start()
        clients = _Clients(httpd.port)
        follower = None
        try:
            for body in subs:
                created = _call_json(clients, "subscribe", "POST", "/v1/subscribe", body)
                if created != {"sub_id": body["sub_id"], "created": True}:
                    raise AssertionError(f"subscribe: {created}")
            listing = _call_json(clients, "subscriptions", "GET", "/v1/subscriptions")
            if listing["count"] != len(subs):
                raise AssertionError(f"subscriptions: {listing['count']}")
            session = _NodeSession(store, tipsets)
            follower = ChainFollower(LotusClient(CLI_ENDPOINT, session=session, metrics=service.metrics),
                                     service.blockstore, metrics=service.metrics, lag=0,
                                     start_height=tipsets[0].height, backend=service.match_backend)
            follower.add_finalized_hook(sq.on_tipset)
            webhook_up = [b["sub_id"] for b in subs if "/up/" in b.get("target", {}).get("url", "")]
            gc.collect()
            _reset_counts()
            t0 = time.perf_counter()
            finalized = 0
            while finalized < len(tipsets):
                finalized += follower.poll_once()
            feed_s = time.perf_counter() - t0
            _wait_for("subs push", lambda: all(not sq.log.pending(s) for s in webhook_up))
            push_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            push_launches = _counts()
            snap = service.metrics_snapshot()
            counters = snap["counters"]
            # the long-poll subscribers: every cursor once, in order; asking
            # from the last cursor acks them all
            polled = {}
            for body in subs:
                if "target" in body:
                    continue
                sub_id = body["sub_id"]
                got = _call_json(clients, "deliveries", "GET", f"/v1/deliveries?sub={sub_id}&cursor=0")
                cursors = [d["cursor"] for d in got["deliveries"]]
                if cursors != list(range(1, len(cursors) + 1)) or not cursors:
                    raise AssertionError(f"deliveries {sub_id}: cursors {cursors}")
                again = _call_json(clients, "deliveries", "GET", f"/v1/deliveries?sub={sub_id}&cursor={cursors[-1]}")
                if again["deliveries"] or sq.log.pending(sub_id):
                    raise AssertionError(f"deliveries {sub_id}: the cursor did not ack")
                polled[sub_id] = got["deliveries"]
            health = _call_json(clients, "healthz", "GET", "/healthz")
            down_pending = {b["sub_id"]: [d.to_json_obj() for d in sq.log.pending(b["sub_id"])]
                            for b in subs if "/down/" in b.get("target", {}).get("url", "")}
        finally:
            clients.close()
            httpd.shutdown(timeout=120)
        if health.get("subscriptions") != len(subs) or health.get("subs_degraded") is not False \
                or health.get("pending_deliveries") != sum(len(v) for v in down_pending.values()) \
                or "slo" not in health or health["slo"]["status"] not in ("ok", "warn", "burning"):
            raise AssertionError(f"healthz: {json.dumps({k: health.get(k) for k in ('subscriptions', 'pending_deliveries', 'subs_degraded', 'slo')})}")

        # generate once per distinct (pair, filter); the storage leg fails
        filters = {filter_key(normalize_filter(b["filter"])): normalize_filter(b["filter"]) for b in subs}
        event_filters = {k: f for k, f in filters.items() if "slot" not in f}
        matched = len(tipsets) - 1
        windows = snap["timers"].get("serve.backfill_window", {}).get("calls", 0)
        if counters.get("subs.tipsets_matched") != matched \
                or counters.get("subs.generations") != len(event_filters) * matched \
                or counters.get("subs.errors") != (len(filters) - len(event_filters)) * matched \
                or windows != len(filters) * matched:
            raise AssertionError(f"subs: generations {counters.get('subs.generations')}, errors "
                                 f"{counters.get('subs.errors')}, lane windows {windows} over {matched} pairs")
        _require_launched("subs push", push_launches, ["event_match_mask_fp"])

        # every push and every polled delivery against the chunked driver
        by_height = {pair.child.height: pair for pair in fed_pairs}
        expected: dict = {}

        def want(sub_id: str, height: int):
            filt = normalize_filter(next(b["filter"] for b in subs if b["sub_id"] == sub_id))
            key = (height, filter_key(filt))
            if key not in expected:
                obj = generate_event_proofs_for_range_chunked(
                    store, [by_height[height]], EventProofSpec(SIGNATURE, filt["topic1"], filt.get("actor_id")),
                    chunk_size=8, match_backend=backend,
                ).to_json_obj()
                expected[key] = (obj, bundle_obj_digest(obj))
            return expected[key]

        by_digest: dict = {}
        first_life = [p for p in posts() if p["status"] == 200]
        deliveries = 0
        for post_ in first_life:
            env = json.loads(post_["body"])
            obj, digest = want(env["sub_id"], env["tipset"])
            if env["digest"] != digest:
                raise AssertionError(f"subs push {env['sub_id']}@{env['tipset']}: digest differs")
            by_digest[digest] = obj
            if "bundle" in env:
                if not post_["body"].endswith(', "bundle": ' + json.dumps(obj, sort_keys=True) + "}"):
                    raise AssertionError(f"subs push {env['sub_id']}@{env['tipset']}: bundle bytes differ")
            deliveries += 1
        n_delta = 0
        for post_ in first_life:
            env = json.loads(post_["body"])
            if "bundle_delta" in env:
                base = UnifiedProofBundle.from_json_obj(by_digest[env["bundle_delta"]["base_digest"]])
                if apply_delta(env["bundle_delta"], base).to_json_obj() != want(env["sub_id"], env["tipset"])[0]:
                    raise AssertionError(f"subs push {env['sub_id']}@{env['tipset']}: the delta expands wrong")
                n_delta += 1
        for sub_id, entries in polled.items():
            for entry in entries:
                obj, digest = want(sub_id, entry["tipset"])
                if entry["digest"] != digest or ("bundle" in entry["payload"] and entry["payload"]["bundle"] != obj):
                    raise AssertionError(f"deliveries {sub_id}@{entry['tipset']}: differs from the chunked driver")
        if not deliveries or counters.get("subs.pushes") != deliveries:
            raise AssertionError(f"subs push: {deliveries} pushes landed, subs.pushes {counters.get('subs.pushes')}")

        # every delivered bundle verified on the card
        gc.collect()
        _reset_counts()
        t0 = time.perf_counter()
        for obj in by_digest.values():
            bundle = UnifiedProofBundle.from_json_obj(obj)
            if not verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True,
                                       cid_backend=backend).all_valid():
                raise AssertionError("subs verify: a delivered bundle does not verify")
        torch.cuda.synchronize()
        verify_ms = (time.perf_counter() - t0) * 1e3
        verify_launches = _counts()
        _require_blake2b("subs verify", verify_launches)

        # restart: the registry replays, the refused deliveries re-push
        os.unlink(os.path.join(work, "down"))
        refused = {(json.loads(p["body"])["sub_id"], json.loads(p["body"])["cursor"]): p["body"]
                   for p in posts() if p["status"] == 503}
        n_before = len(posts())
        t0 = time.perf_counter()
        service = ProofService(store=store, spec=spec, config=ServiceConfig(**svc_cfg))
        sq = _standing(root, service)
        try:
            _wait_for("subs restart", lambda: not any(sq.log.pending(s) for s in down_pending))
            restart_ms = (time.perf_counter() - t0) * 1e3
            replayed = len(sq.registry)
        finally:
            sq.drain()
            service.drain()
        repushed = {(json.loads(p["body"])["sub_id"], json.loads(p["body"])["cursor"]): p["body"]
                    for p in posts()[n_before:] if p["status"] == 200}
        want_repush = {(s, d["cursor"]) for s, ds in down_pending.items() for d in ds}
        if replayed != len(subs) or set(repushed) != want_repush or not want_repush \
                or any(repushed[k] != refused[k] for k in want_repush):
            raise AssertionError(f"subs restart: {replayed} subscriptions, re-pushed {len(repushed)} of "
                                 f"{len(want_repush)} refused deliveries")
    return {
        "subscriptions": len(subs),
        "distinct_filters": len(filters),
        "tipsets": len(tipsets),
        "pairs_matched": matched,
        "generations": counters["subs.generations"],
        "generations_per_s": counters["subs.generations"] / feed_s,
        "webhook_deliveries": deliveries,
        "delta_deliveries": n_delta,
        "push_deliveries_per_s": deliveries / push_s,
        "feed_ms": feed_s * 1e3,
        "push_ms": push_s * 1e3,
        "ms_per_tipset": feed_s * 1e3 / len(tipsets),
        "polled_deliveries": sum(len(v) for v in polled.values()),
        "refused_then_repushed": len(want_repush),
        "restart_ms": restart_ms,
        "verify_ms": verify_ms,
        "bundles_verified": len(by_digest),
        "counters": {k: v for k, v in counters.items() if k.startswith(("subs.", "witness.delta", "follow."))},
        "stages": _stages(snap),
        "slo": health["slo"],
        "launches": push_launches,
        "verify_launches": verify_launches,
    }


def _stages(snap) -> dict:
    """Busy ms and calls of each timed stage in a metrics snapshot."""
    return {k: [round(v["total_s"] * 1e3, 1), v["calls"]] for k, v in snap["timers"].items()}


def _fold_stream(clients, job_id: str, pairs):
    """Poll ``GET /v1/backfill/<id>/chunks`` as an IPBS stream until the
    job ends, folding every chunk document: (sealed bundle, chunks, ms to
    the first response's headers, stream polls)."""
    from ipc_proofs_tpu_torch.cluster import BundleFold
    from ipc_proofs_tpu_torch.witness.stream import STREAM_CONTENT_TYPE, decode_bundle_stream_docs

    fold = BundleFold(pairs, range(len(pairs)))
    cursor, chunks, polls, ttfb = 0, 0, 0, None
    while True:
        status, _, raw, t_head, _ = clients.request(
            "GET", f"/v1/backfill/{job_id}/chunks?cursor={cursor}&wait_s=10",
            headers={"Accept": STREAM_CONTENT_TYPE},
        )
        if status != 200:
            raise AssertionError(f"backfill stream: HTTP {status}: {raw[:300]!r}")
        ttfb = t_head if ttfb is None else ttfb
        polls += 1
        docs = decode_bundle_stream_docs(raw)
        envelope = docs[-1]
        for doc in docs[:-1]:
            fold.fold(UnifiedProofBundle.from_json_obj(doc["bundle"]))
            chunks += 1
        cursor = envelope["cursor"]
        if envelope["state"] != "running" and len(docs) == 1:
            if envelope["state"] != "complete":
                raise AssertionError(f"backfill stream: the job ended {envelope['state']}")
            return fold.seal(), chunks, ttfb, polls


def backfill_phase(world, device, root: str) -> dict:
    """Backfill over all 4,096 pairs of the event world at window size 8 on
    the service's LOW lane (the scan unfused: the event mask on the card):
    the engine is closed after 128 windows committed, a second engine
    resumes from the journal, and the sealed bundle is ``range``'s bytes and
    verifies on the card; then ``POST /v1/backfill`` over HTTP, its
    ``GET /v1/backfill/<id>/chunks`` streamed to the end and folded with
    `BundleFold`: the same bytes; then ``python -m ipc_proofs_tpu_torch.cli
    backfill --endpoint`` over the hermetic node at 64 pairs, every landed
    wave verified on the card (``IPC_VERIFY_MIN_BYTES=0``)."""
    from ipc_proofs_tpu_torch.backfill import BackfillEngine, BackfillError

    store, pairs, _ = world
    backend = get_backend("gpu", device=device)
    spec = EventProofSpec(SIGNATURE, TOPIC1)
    expected = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend).to_json()
    jobs = os.path.join(root, "backfill-jobs")
    service = ProofService(store=store, spec=spec, config=ServiceConfig(workers=2, device=_service_device(device)))

    def engine(jobs_dir):
        return BackfillEngine(pairs, spec, lambda w, wpairs: service.submit_range_window(wpairs).result(),
                              jobs_dir=jobs_dir, window_size=BACKFILL_WINDOW, plane=service.fetch_plane,
                              metrics=service.metrics)

    try:
        with _env("IPC_SCAN_FUSED_MATCH", "0"):
            gc.collect()
            _reset_counts()
            first = engine(jobs)
            t0 = time.perf_counter()
            job = first.submit(0, len(pairs))
            cursor = 0
            while cursor < BACKFILL_KILL_AT:
                cursor = job.chunks_after(cursor, wait_s=10)["cursor"]
            first.close(timeout=120)
            killed_s = time.perf_counter() - t0
            try:
                job.result(timeout=0)
                raise AssertionError("backfill: the closed engine's job completed")
            except BackfillError:
                pass
            committed = job.status()["windows_done"]
            second = engine(jobs)
            t0 = time.perf_counter()
            resumed = second.submit(0, len(pairs))
            sealed = resumed.result(timeout=900)
            resume_s = time.perf_counter() - t0
            status = resumed.status()
            second.close(timeout=60)
            gen_stages = _stages(service.metrics.snapshot())
            torch.cuda.synchronize()
            gen_launches = _counts()
            if resumed.job_id != job.job_id or status["windows_replayed"] != committed:
                raise AssertionError(f"backfill resume: {status['windows_replayed']} replayed, {committed} committed")
            if sealed.to_json() != expected:
                raise AssertionError("backfill: the sealed bundle differs from range over the same pairs")
            t0 = time.perf_counter()
            if not verify_proof_bundle(sealed, TrustPolicy.accept_all(), verify_witness_cids=True,
                                       cid_backend=backend).all_valid():
                raise AssertionError("backfill: the sealed bundle does not verify")
            torch.cuda.synchronize()
            verify_ms = (time.perf_counter() - t0) * 1e3
            launches = _counts()
            _require_launched("backfill", launches, ["event_match_mask_fp"])
            _require_blake2b("backfill", launches)

            # the HTTP door: submit, stream to the end, fold
            http_engine = engine(os.path.join(root, "backfill-http"))
            httpd = ProofHTTPServer(service, pairs=pairs, backfill=http_engine).start()
            clients = _Clients(httpd.port)
            try:
                gc.collect()
                _reset_counts()
                t0 = time.perf_counter()
                submitted = _call_json(clients, "backfill submit", "POST", "/v1/backfill",
                                       {"pair_start": 0, "pair_end": len(pairs)})
                folded, chunks, ttfb_ms, polls = _fold_stream(clients, submitted["job_id"], pairs)
                http_s = time.perf_counter() - t0
                torch.cuda.synchronize()
                stream_launches = _counts()
                http_status = _call_json(clients, "backfill status", "GET", f"/v1/backfill/{submitted['job_id']}")
            finally:
                clients.close()
                httpd.shutdown(timeout=120)
            service = None  # drained by the server's shutdown
    finally:
        if service is not None:
            service.drain()
    if folded.to_json() != expected or chunks != http_status["windows_total"] or http_status["state"] != "complete":
        raise AssertionError(f"backfill stream: {chunks} chunks folded, status {http_status['state']}")
    _require_launched("backfill stream", stream_launches, ["event_match_mask_fp"])

    # the CLI over the hermetic node, the verify lane on the card
    store_c, pairs_c, n_matching = build_range_world(CLI_BACKFILL_PAIRS, 16, 4, 0.01, chained=True)
    tipsets = [pairs_c[0].parent] + [pair.child for pair in pairs_c]
    cli_expected = generate_event_proofs_for_range(store_c, pairs_c, spec, match_backend=backend).to_json()
    session = _NodeSession(store_c, tipsets)
    recording = _RecordingBackend(get_backend("gpu", device=device))
    path = os.path.join(root, "cli-backfill.json")
    argv = [
        "backfill", "--endpoint", CLI_ENDPOINT,
        "--from-height", str(tipsets[0].height), "--to-height", str(tipsets[-2].height),
        "--event-sig", SIGNATURE, "--topic1", TOPIC1, "--window-size", str(CLI_BACKFILL_WINDOW),
        "--jobs-dir", os.path.join(root, "cli-backfill-jobs"), "--backend", "gpu", "--metrics", "-o", path,
    ]
    gc.collect()
    with _cli_node(session, recording), _env("IPC_VERIFY_MIN_BYTES", "0"):
        _, cli_ms, cli_launches, cli_snap = _cli("cli backfill", argv)
    with open(path) as fh:
        if fh.read() != cli_expected:
            raise AssertionError("cli backfill: the bundle differs from range over the same pairs")
    _require_launched("cli backfill", cli_launches, ["event_match_mask"])
    _require_blake2b("cli backfill", cli_launches)
    checked = _check_recorded("cli backfill", recording, {})
    fresh = len(pairs) - committed * BACKFILL_WINDOW
    return {
        "pairs": len(pairs),
        "window_size": BACKFILL_WINDOW,
        "windows": status["windows_total"],
        "committed_before_close": committed,
        "killed_ms": killed_s * 1e3,
        "resume_ms": resume_s * 1e3,
        "resume_first_chunk_ms": (status["first_chunk_s"] or 0.0) * 1e3,
        "backfill_pairs_per_s": len(pairs) / (killed_s + resume_s),
        "resumed_fresh_pairs_per_s": fresh / resume_s,
        "proofs": len(sealed.event_proofs),
        "verify_ms": verify_ms,
        "http_pairs_per_s": len(pairs) / http_s,
        "http_ms": http_s * 1e3,
        "stream_ttfb_ms": ttfb_ms,
        "stream_polls": polls,
        "stream_chunks": chunks,
        "cli": {"pairs": len(pairs_c), "proofs": n_matching, "wall_ms": cli_ms,
                "rpc_calls": cli_snap["counters"].get("rpc.calls", 0), "checked": checked},
        "stages": gen_stages,
        "generate_launches": gen_launches,
        "launches": launches,
        "stream_launches": stream_launches,
        "cli_launches": cli_launches,
    }


# --------------------------------------------------------------------------
# the cluster router and its shards
# --------------------------------------------------------------------------

CLUSTER_SHARDS = (1, 2, 4)
CLUSTER_CHUNK = 1024
CLUSTER_LOAD_REQUESTS = 512  # single-pair generates through the 4-shard router
CLUSTER_LOAD_CLIENTS = 8
CLUSTER_STEAL_THRESHOLD = 2  # the JAX bench.py cluster leg's
HOSTKILL_WORLD = (16, 8, 0.25)  # the JAX bench.py hostkill leg's world, uncut: pairs, receipts, match rate
HOSTKILL_REQUESTS = 64
HOSTKILL_CLIENTS = 4
CLUSTER_BACKFILL_PAIRS = 256
# 128 pairs and 512 requests (256 and 1,024 until phase 32 came)
CLI_CLUSTER_WORLD = (128, 8, 0.25)  # --demo-world, --demo-receipts, --demo-match-rate
CLI_CLUSTER_REQUESTS = 512
CLI_CLUSTER_CLIENTS = 8


def _scatter_masks(router, pairs, chunk: int) -> int:
    """The fingerprint masks a scatter launches on its shards (the scan
    unfused): one a chunk of each group the router forms from its ring."""
    from ipc_proofs_tpu_torch.cluster import pair_ring_key

    with router._lock:
        owners = [router._affinity_locked(pair_ring_key(pair)) for pair in pairs]
    return sum(-(-owners.count(name) // chunk) for name in set(owners))


def _require_only(label: str, launches: "dict[str, int]", **want) -> None:
    """``launches`` must be exactly ``want``, every other kernel at 0."""
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        raise AssertionError(f"{label}: launches {launches}, expected {full}")


def _pair_proofs(bundle) -> "dict[tuple[int, int], list]":
    """A range bundle's event proofs by (parent epoch, child epoch)."""
    out: dict = {}
    for proof in bundle.to_json_obj()["event_proofs"]:
        out.setdefault((proof["parent_epoch"], proof["child_epoch"]), []).append(proof)
    return out


def _hostkill(device, root: str) -> dict:
    """The JAX ``hostkill`` leg's shape on the card: two `LocalShard`s with
    their own disk tiers (every spill a rolled segment, a 1-byte cache so
    reads hit the disk), ``replication_factor=2``. Warm, replicate, corrupt
    every rolled frame on ``s0``: the scatter stays byte-identical and
    ``replica_repair_hit_rate`` is the share of integrity evictions the
    peer refetched. Then a closed loop of single-pair generates, ``s1``
    killed a quarter of the way in: ``kill_recovery_ms`` runs from the
    kill until a full scatter over every pair completes byte-identical on
    the survivor."""
    from ipc_proofs_tpu_torch.cluster import ClusterRouter, LocalShard

    n_pairs, receipts, match_rate = HOSTKILL_WORLD
    store, pairs, _ = build_range_world(n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
                                        signature=SIGNATURE, topic1=TOPIC1)
    spec = EventProofSpec(SIGNATURE, TOPIC1)
    expected = json.dumps(generate_event_proofs_for_range_chunked(
        store, pairs, spec, chunk_size=8, match_backend=get_backend("gpu", device=device)).to_json_obj(), sort_keys=True)
    idxs = list(range(n_pairs))
    work = os.path.join(root, "hostkill")
    shard_metrics = [Metrics() for _ in range(2)]
    shards = [
        LocalShard(f"s{k}", store, pairs, spec, metrics=shard_metrics[k], config=ServiceConfig(
            max_batch=8, max_wait_ms=5.0, workers=1, store_dir=os.path.join(work, f"s{k}"), store_owner=f"s{k}",
            store_segment_max_bytes=1, cache_max_bytes=1, device=_service_device(device),
        )).start()
        for k in range(2)
    ]
    metrics = Metrics()
    router = ClusterRouter({s.name: s.url for s in shards}, pairs, replication_factor=2, metrics=metrics,
                           scrape_interval_s=60.0)
    try:
        gc.collect()
        _reset_counts()
        status, obj = router.generate_range(idxs, chunk_size=8)
        if status != 200 or json.dumps(obj["bundle"], sort_keys=True) != expected:
            raise AssertionError(f"hostkill warm scatter: HTTP {status}")
        summary = router.replicate_now()
        if summary["errors"] or summary["under_replicated"]:
            raise AssertionError(f"hostkill replication: {summary}")
        flipped = 0
        s0_dir = os.path.join(work, "s0")
        for name in sorted(os.listdir(s0_dir)):
            if name.endswith(".blk"):
                path = os.path.join(s0_dir, name)
                with open(path, "r+b") as fh:
                    fh.seek(os.path.getsize(path) - 1)
                    byte = fh.read(1)
                    fh.seek(os.path.getsize(path) - 1)
                    fh.write(bytes([byte[0] ^ 0x40]))
                flipped += 1
        status, obj = router.generate_range(idxs, chunk_size=8)
        if status != 200 or json.dumps(obj["bundle"], sort_keys=True) != expected:
            raise AssertionError(f"hostkill: the scatter after corruption differs (HTTP {status})")
        c0 = shard_metrics[0].snapshot()["counters"]
        repairs, misses = c0.get("storex.replica_repairs", 0), c0.get("storex.replica_repair_misses", 0)
        if not flipped or not repairs:
            raise AssertionError(f"hostkill: {flipped} frames flipped, {repairs} repaired, {misses} missed")

        def load():
            answers, wall = _closed_loop(HOSTKILL_REQUESTS, HOSTKILL_CLIENTS,
                                         lambda i: router.generate(i % n_pairs))
            bad = [obj for status, obj in answers if status != 200]
            if bad:
                raise AssertionError(f"hostkill load: {len(bad)} failed answers: {bad[0]}")
            return sum(obj["n_event_proofs"] for _, obj in answers), wall

        proofs, wall = load()
        killer = threading.Timer(wall * 0.25, shards[1].kill)
        outcome: dict = {}

        def second_load():
            try:
                outcome["load"] = load()
            except BaseException as exc:  # re-raised below, on the main thread
                outcome["error"] = exc

        killer.start()
        loader = threading.Thread(target=second_load)
        loader.start()
        killer.join()
        t_kill = time.perf_counter()
        recovery_ms = None
        while time.perf_counter() < t_kill + 60.0:
            status, obj = router.generate_range(idxs, chunk_size=8)
            if status == 200 and json.dumps(obj["bundle"], sort_keys=True) == expected:
                recovery_ms = (time.perf_counter() - t_kill) * 1e3
                break
        loader.join(300)
        torch.cuda.synchronize()
        launches = _counts()
        if "error" in outcome:
            raise outcome["error"]
        if recovery_ms is None:
            raise AssertionError("hostkill: no byte-identical scatter within 60 s of the kill")
        if router.alive_shards() != ["s0"]:
            raise AssertionError(f"hostkill: alive {router.alive_shards()} after killing s1")
        _require_launched("cluster hostkill", launches, ["event_match_mask"])
        return {
            "pairs": n_pairs,
            "frames_flipped": flipped,
            "replica_repairs": repairs,
            "replica_repair_misses": misses,
            "replica_repair_hit_rate": repairs / (repairs + misses),
            "aggregate_proofs_per_sec_2host": proofs / wall,
            "kill_recovery_ms": recovery_ms,
            "shard_failovers": metrics.counter_value("cluster.shard_failovers"),
            "launches": launches,
        }
    finally:
        router.close()
        for s in shards:
            s.stop(timeout=120)


def cluster_phase(world, device, root: str) -> dict:
    """`ClusterRouter` over 1, 2 and 4 `LocalShard`s on the card (the shards
    share this process's backend and launch counters), the event world
    (kept alive until then) with the scan unfused: ``generate_range`` over
    all 4,096 pairs at chunk 1,024, buffered in process and streamed
    cut-through over `RouterHTTPServer`, each the chunked driver's bytes
    with one fingerprint mask a chunk of each group the router formed and
    nothing else; each bundle through the router's ``/v1/verify`` with the
    witness CIDs on, all true, one blake2b launch set; at 4 shards a closed
    loop of single-pair generates from 8 clients (steal threshold 2), each
    answer's proofs those of its pair; the ``hostkill`` shape
    (`_hostkill`); ``POST /v1/backfill`` over 256 pairs through the
    router, its chunk stream folded into the chunked driver's bytes."""
    from ipc_proofs_tpu_torch.cluster import ClusterRouter, LocalShard, RouterHTTPServer
    from ipc_proofs_tpu_torch.witness.stream import STREAM_CONTENT_TYPE

    store, pairs, _ = world
    spec = EventProofSpec(SIGNATURE, TOPIC1)
    backend = get_backend("gpu", device=device)
    expected = generate_event_proofs_for_range_chunked(store, pairs, spec, chunk_size=CLUSTER_CHUNK,
                                                       match_backend=backend)
    expected_json = json.dumps(expected.to_json_obj(), sort_keys=True)
    by_pair = _pair_proofs(expected)
    verify_want = _blake2b_set([expected])
    idxs = list(range(len(pairs)))
    runs: dict = {}
    launches: dict = {}

    def shards_up(n, **cfg):
        return [LocalShard(f"s{i}", store, pairs, spec,
                           config=ServiceConfig(device=_service_device(device), **cfg)).start() for i in range(n)]

    with _env("IPC_SCAN_FUSED_MATCH", "0"):
        for n in CLUSTER_SHARDS:
            shards = shards_up(n, max_wait_ms=1.0, verify_witness_cids=True)
            metrics = Metrics()
            router = ClusterRouter({s.name: s.url for s in shards}, pairs, metrics=metrics,
                                   steal_threshold=CLUSTER_STEAL_THRESHOLD, scrape_interval_s=60.0)
            server = RouterHTTPServer(router).start()
            clients = _Clients(server.port)
            try:
                masks = _scatter_masks(router, pairs, CLUSTER_CHUNK)
                gc.collect()
                _reset_counts()
                t0 = time.perf_counter()
                status, obj = router.generate_range(idxs, chunk_size=CLUSTER_CHUNK)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                scatter = _counts()
                if status != 200 or json.dumps(obj["bundle"], sort_keys=True) != expected_json:
                    raise AssertionError(f"cluster ({n} shards): the scatter differs from the driver (HTTP {status})")
                _require_only(f"cluster ({n} shards)", scatter, event_match_mask_fp=masks)

                _reset_counts()
                t0 = time.perf_counter()
                status, hdrs, raw, ttfb_ms, _ = clients.request(
                    "POST", "/v1/generate_range", {"pair_indexes": idxs, "chunk_size": CLUSTER_CHUNK},
                    headers={"Accept": STREAM_CONTENT_TYPE})
                torch.cuda.synchronize()
                stream_wall = time.perf_counter() - t0
                stream = _counts()
                if status != 200 or hdrs.get("Content-Type") != STREAM_CONTENT_TYPE:
                    raise AssertionError(f"cluster stream ({n} shards): HTTP {status}: {raw[:300]!r}")
                if json.dumps(decode_bundle_stream(raw)["bundle"], sort_keys=True) != expected_json:
                    raise AssertionError(f"cluster stream ({n} shards): the folded stream differs from the buffered")
                if metrics.counter_value("cluster.stream_cut_through") != obj["n_groups"]:
                    raise AssertionError(f"cluster stream ({n} shards): a group was not relayed cut-through")
                _require_only(f"cluster stream ({n} shards)", stream, event_match_mask_fp=masks)

                _reset_counts()
                t0 = time.perf_counter()
                status, verdict = router.verify({"bundle": obj["bundle"]})
                torch.cuda.synchronize()
                verify_ms = (time.perf_counter() - t0) * 1e3
                verify = _counts()
                if status != 200 or verdict.get("all_valid") is not True:
                    raise AssertionError(f"cluster verify ({n} shards): HTTP {status}, {str(verdict)[:300]}")
                _require_only(f"cluster verify ({n} shards)", verify, **verify_want)
                for name, counts in (("scatter", scatter), ("stream", stream), ("verify", verify)):
                    total = launches.setdefault(name, dict.fromkeys(counts, 0))
                    for kernel, count in counts.items():
                        total[kernel] += count
                run = {
                    "groups": obj["n_groups"],
                    "masks": masks,
                    "scatter_ms": wall * 1e3,
                    "proofs_per_s": len(expected.event_proofs) / wall,
                    "stream_ms": stream_wall * 1e3,
                    "stream_ttfb_ms": ttfb_ms,
                    "stream_proofs_per_s": len(expected.event_proofs) / stream_wall,
                    "verify_ms": verify_ms,
                }
                if n == max(CLUSTER_SHARDS):
                    _reset_counts()
                    answers, load_wall = _closed_loop(CLUSTER_LOAD_REQUESTS, CLUSTER_LOAD_CLIENTS,
                                                      lambda i: router.generate(i % len(pairs)))
                    torch.cuda.synchronize()
                    launches["load"] = _counts()
                    n_proofs = 0
                    for i, (status, answer) in enumerate(answers):
                        pair = pairs[i % len(pairs)]
                        got = answer.get("bundle", {}).get("event_proofs") if status == 200 else None
                        if got != by_pair.get((pair.parent.height, pair.child.height), []):
                            raise AssertionError(f"cluster load: pair {i % len(pairs)} answered HTTP {status}")
                        n_proofs += len(got)
                    _require_launched("cluster load", launches["load"], ["event_match_mask_fp"])
                    run.update(load_requests=CLUSTER_LOAD_REQUESTS, load_rps=CLUSTER_LOAD_REQUESTS / load_wall,
                               load_proofs_per_s=n_proofs / load_wall)
                counters = metrics.snapshot()["counters"]
                run["steal_events"] = counters.get("cluster.steals", 0)
                run["shard_failovers"] = counters.get("cluster.shard_failovers", 0)
                if run["shard_failovers"] or counters.get("cluster.shard_errors", 0):
                    raise AssertionError(f"cluster ({n} shards): a live shard was failed over: {counters}")
                runs[n] = run
            finally:
                clients.close()
                server.shutdown(timeout=120)
                for s in shards:
                    s.stop(timeout=120)

        hostkill = _hostkill(device, root)

        # the router's backfill door over two shards
        n_bf = CLUSTER_BACKFILL_PAIRS
        bf_expected = generate_event_proofs_for_range_chunked(store, pairs[:n_bf], spec, chunk_size=CLUSTER_CHUNK,
                                                              match_backend=backend).to_json()
        shards = shards_up(2)
        router = ClusterRouter({s.name: s.url for s in shards}, pairs, scrape_interval_s=60.0,
                               backfill_jobs_dir=os.path.join(root, "cluster-backfill"),
                               backfill_window_size=BACKFILL_WINDOW, spec=spec)
        server = RouterHTTPServer(router).start()
        clients = _Clients(server.port)
        try:
            gc.collect()
            _reset_counts()
            t0 = time.perf_counter()
            job = _call_json(clients, "cluster backfill", "POST", "/v1/backfill", {"pair_start": 0, "pair_end": n_bf})
            folded, chunks, bf_ttfb_ms, polls = _fold_stream(clients, job["job_id"], pairs[:n_bf])
            bf_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches["backfill"] = _counts()
        finally:
            clients.close()
            server.shutdown(timeout=120)
            for s in shards:
                s.stop(timeout=120)
    windows = n_bf // BACKFILL_WINDOW
    if folded.to_json() != bf_expected or chunks != windows:
        raise AssertionError(f"cluster backfill: {chunks} chunks folded into other bytes than the driver's")
    per_window = -(-BACKFILL_WINDOW // ServiceConfig().range_chunk_size)
    _require_only("cluster backfill", launches["backfill"], event_match_mask_fp=windows * per_window)
    return {
        "pairs": len(pairs),
        "proofs": len(expected.event_proofs),
        "chunk_size": CLUSTER_CHUNK,
        "runs": {str(n): run for n, run in runs.items()},
        "proofs_per_s": {str(n): run["proofs_per_s"] for n, run in runs.items()},
        "steal_events": sum(run["steal_events"] for run in runs.values()),
        "hostkill": {k: v for k, v in hostkill.items() if k != "launches"},
        "backfill": {"pairs": n_bf, "windows": windows, "ms": bf_s * 1e3, "pairs_per_s": n_bf / bf_s,
                     "stream_ttfb_ms": bf_ttfb_ms, "polls": polls},
        "launches": launches["scatter"],
        "stream_launches": launches["stream"],
        "verify_launches": launches["verify"],
        "load_launches": launches["load"],
        "hostkill_launches": hostkill["launches"],
        "backfill_launches": launches["backfill"],
    }


def _cli_cluster_run(n_shards: int, device, work: str, by_pair) -> dict:
    """One ``python -m ipc_proofs_tpu_torch.cli cluster`` child over the CLI
    world with ``--store-dir`` and ``--queue-dir``, driven by
    `CLI_CLUSTER_CLIENTS` closed-loop HTTP clients in a child process with
    `CLI_CLUSTER_REQUESTS` ``/v1/generate`` requests, then SIGTERMed. Each
    shard's launches are its log's: the difference of its two ``kernel
    launches:`` lines."""
    os.makedirs(work, exist_ok=True)
    port_file = os.path.join(work, "port")
    n_pairs, receipts, match_rate = CLI_CLUSTER_WORLD
    argv = [sys.executable, "-m", "ipc_proofs_tpu_torch.cli", "cluster", "--shards", str(n_shards),
            "--demo-world", str(n_pairs), "--demo-receipts", str(receipts), "--demo-match-rate", str(match_rate),
            "--store-dir", os.path.join(work, "seg"), "--queue-dir", os.path.join(work, "queue"),
            "--port", "0", "--port-file", port_file, "--scrape-interval-s", "1"]
    if torch.device(device).type != "cuda":  # a run of the phase on the CPU
        argv += ["--backend", "cpu"]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=here, env=dict(os.environ, PYTHONPATH=here),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    clients = None
    failure = None
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(port_file) and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if not os.path.exists(port_file):
            raise AssertionError(f"cli cluster --shards {n_shards} did not come up: {proc.poll()}")
        start_ms = (time.perf_counter() - t0) * 1e3
        with open(port_file) as fh:
            port = int(fh.read())
        clients = _Clients(port)
        health = _call_json(clients, "cli cluster healthz", "GET", "/healthz")
        if health["status"] != "ok" or health["shards_alive"] != n_shards:
            raise AssertionError(f"cli cluster --shards {n_shards}: healthz {health}")
        requests = [("POST", "/v1/generate", {"pair_index": i % n_pairs}) for i in range(CLI_CLUSTER_REQUESTS)]
        answers, wall = _remote_closed_loop(port, requests, CLI_CLUSTER_CLIENTS)
        n_proofs = 0
        bundles = {}
        for i, (status, _, raw, _, _) in enumerate(answers):
            result = _ok_json("cli cluster generate", status, raw)["result"]
            pair = i % n_pairs
            if result["bundle"]["event_proofs"] != by_pair[pair]:
                raise AssertionError(f"cli cluster generate: pair {pair}'s proofs differ from the driver's")
            n_proofs += len(result["bundle"]["event_proofs"])
            if by_pair[pair]:
                bundles.setdefault(pair, result["bundle"])
        # each pair's bundle verified through the router (placed by its
        # digest on the ring: every shard verifies some)
        verifies = [("POST", "/v1/verify", {"bundle": bundle}) for _, bundle in sorted(bundles.items())]
        answers, verify_wall = _remote_closed_loop(port, verifies, CLI_CLUSTER_CLIENTS)
        for status, _, raw, _, _ in answers:
            if _ok_json("cli cluster verify", status, raw)["result"]["all_valid"] is not True:
                raise AssertionError("cli cluster verify: a verdict is false")
        time.sleep(1.5)  # one federation scrape after the load
        status_obj = _call_json(clients, "cli cluster status", "GET", "/v1/cluster/status")
        status, _, prom, _, _ = clients.request("GET", "/metrics.prom")
        if status != 200 or b'shard="fleet"' not in prom or b'shard="router"' not in prom:
            raise AssertionError(f"cli cluster metrics.prom: HTTP {status}")
        router_counters = _call_json(clients, "cli cluster metrics", "GET", "/metrics.json")["counters"]
        shard_snaps = {}
        for name, entry in status_obj["ring"].items():
            shard = _Clients(int(entry["url"].rsplit(":", 1)[1]))
            try:
                shard_snaps[name] = _call_json(shard, f"cli cluster shard {name} metrics", "GET", "/metrics.json")
            finally:
                shard.close()
    except BaseException as exc:  # re-raised below with the cluster's stderr
        failure = exc
    finally:
        if clients is not None:
            clients.close()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    if failure is not None:
        raise AssertionError(f"cli cluster --shards {n_shards}: {failure}; its stderr: {err[-3000:]}") from failure
    if proc.returncode != 0:
        raise AssertionError(f"cli cluster --shards {n_shards} exited {proc.returncode}: {err[-3000:]}")
    logs = dict(re.findall(r"shard (s\d+) up at http://\S+ \(log (\S+)\)", err))
    if sorted(logs) != sorted(shard_snaps) or len(logs) != n_shards:
        raise AssertionError(f"cli cluster --shards {n_shards}: shard logs {logs}, ring {sorted(shard_snaps)}")
    shards = {}
    for name, path in sorted(logs.items()):
        with open(path) as fh:
            text = fh.read()
        os.remove(path)
        logged = [json.loads(line.split("kernel launches: ", 1)[1]) for line in text.splitlines()
                  if "kernel launches: " in line]
        if len(logged) != 2:
            raise AssertionError(f"cli cluster shard {name}: {len(logged)} kernel launch lines: {text[-2000:]}")
        started, drained = logged
        served = {kernel: drained[kernel] - started[kernel] for kernel in drained}
        snap = shard_snaps[name]
        masks = snap["timers"].get("range_match", {}).get("calls", 0)
        generates = snap["counters"].get("serve.batches.generate", 0)
        verify_batches = snap["counters"].get("serve.batches.verify", 0)
        if torch.device(device).type == "cuda":
            # one flat mask a generate chunk, one TxMeta blake2b batch a
            # merged verify batch (the CIDs off, as the cluster's shards run)
            if not generates or masks < generates or not verify_batches:
                raise AssertionError(f"cli cluster shard {name}: {masks} masks for {generates} generate batches, "
                                     f"{verify_batches} verify batches")
            _require_only(f"cli cluster shard {name}", served, event_match_mask=masks,
                          blake2b256_single_block=verify_batches)
        records, _, torn = read_journal(os.path.join(work, "queue", name, QUEUE_JOURNAL_NAME))
        admitted = {r["key"] for r in records if r["t"] == "admit"}
        if torn or admitted != {r["key"] for r in records if r["t"] == "done"}:
            raise AssertionError(f"cli cluster shard {name}: an admit without its done record")
        shards[name] = {"generate_batches": generates, "verify_batches": verify_batches,
                        "admitted": len(admitted), "started": started, "launches": served}
    return {
        "shards": n_shards,
        "start_ms": start_ms,
        "rps": CLI_CLUSTER_REQUESTS / wall,
        "proofs_per_s": n_proofs / wall,
        "verify_requests": len(verifies),
        "verify_rps": len(verifies) / verify_wall,
        "steal_events": router_counters.get("cluster.steals", 0),
        "shard_failovers": router_counters.get("cluster.shard_failovers", 0),
        "per_shard": shards,
        "exit": proc.returncode,
    }


def cli_cluster_phase(device, root: str) -> dict:
    """``python -m ipc_proofs_tpu_torch.cli cluster --shards 4 --demo-world
    64 --demo-receipts 8 --demo-match-rate 0.25`` with ``--store-dir`` and
    ``--queue-dir``, as a user starts it (4 shard processes on the one
    card), then the same with ``--shards 1``: 256 ``/v1/generate`` from 8
    closed-loop clients each, every answer's proofs the chunked driver's for
    its pair, then each pair's bundle (one with events) verified through the
    router, every verdict true; ``/healthz`` ok with every shard alive,
    ``/v1/cluster/status`` and the fleet ``/metrics.prom`` read; SIGTERM
    exits 0 with a done record for every admit of every shard; each shard's
    launches from its log: one flat event mask a generate chunk (its
    ``range_match`` timer) and one TxMeta blake2b batch a merged verify
    batch (``serve.batches.verify``), nothing else. Prints the JAX ``cluster`` leg's
    ``aggregate_proofs_per_sec`` and ``cluster_linearity_4shard`` (recorded,
    not gated: 8 CPUs and one card)."""
    n_pairs, receipts, match_rate = CLI_CLUSTER_WORLD
    store, pairs, _ = build_range_world(n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
                                        signature=SIGNATURE, topic1=TOPIC1)
    spec = EventProofSpec(SIGNATURE, TOPIC1)
    backend = get_backend("gpu", device=device)
    by_pair = [generate_event_proofs_for_range_chunked(store, [pair], spec, chunk_size=8, match_backend=backend)
               .to_json_obj()["event_proofs"] for pair in pairs]
    if not any(by_pair):
        raise AssertionError("cli cluster: the world has no matching event")
    # the kernels exist already (phase 2); the CLI finds them built
    four = _cli_cluster_run(4, device, os.path.join(root, "cli-cluster-4"), by_pair)
    one = _cli_cluster_run(1, device, os.path.join(root, "cli-cluster-1"), by_pair)
    total = {}
    for shard in four["per_shard"].values():
        for kernel, count in shard["launches"].items():
            total[kernel] = total.get(kernel, 0) + count
    return {
        "pairs": n_pairs,
        "requests": CLI_CLUSTER_REQUESTS,
        "clients": CLI_CLUSTER_CLIENTS,
        "aggregate_proofs_per_sec": four["proofs_per_s"],
        "cluster_rps_4shard": four["rps"],
        "cluster_rps_1shard": one["rps"],
        "cluster_linearity_4shard": four["rps"] / (4 * one["rps"]),
        "steal_events": four["steal_events"],
        "runs": {"4": four, "1": one},
        "launches": total,
        "one_shard_launches": one["per_shard"]["s0"]["launches"],
    }


# --------------------------------------------------------------------------
# the fault-injection and audit tools (ipc_proofs_tpu_torch/tools/) on the card
# --------------------------------------------------------------------------

# BASELINE config 2's shape cut to 256 pairs: the faulted pool's cut (phase
# 12a), the deployment a relayer reads through flaky Lotus nodes
TOOLS_WORLD = (256, 16, 4, 0.01)  # pairs, receipts a pair, events a receipt, match rate
CHAOS_RATES = (0.05, 0.5)
CHAOS_SEEDS = 4
CRASH_POINTS = 4
CRASH_CHUNK = 16
SOAK_PHASES = ("event", "storage", "shapes", "codec", "range")
VIOLATIONS = ("divergent", "untyped_error", "device_fault")


def _tool_main(main, argv) -> "tuple[int, str]":
    """A tool's ``main`` as ``python -m`` runs it (default ``--device
    cuda``): (exit code, standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _chaos_tools(seed: int, backend) -> dict:
    """`tools.chaos.run_grid` over the cut world through the fetch plane in
    front of the pool, every landed wave on the card's lane; then the shard
    transport grid at its defaults."""
    n_pairs, receipts, events, match_rate = TOOLS_WORLD
    recording = _RecordingBackend(backend)
    with _env("IPC_VERIFY_MIN_BYTES", "0"):
        _reset_counts()
        t0 = time.perf_counter()
        grid = chaos_tool.run_grid(
            seed, runs=CHAOS_SEEDS, fault_rates=CHAOS_RATES, n_pairs=n_pairs, receipts_per_pair=receipts,
            events_per_receipt=events, match_rate=match_rate, backend=recording, fetch_plane=True,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _counts()
    bad = {k: grid["counts"][k] for k in VIOLATIONS if grid["counts"][k]}
    if not grid["ok"] or bad or not grid["counts"]["identical"]:
        raise AssertionError(f"tools chaos: {grid['counts']} {json.dumps(grid['violations'])[:2000]}")
    _require_blake2b("tools chaos", launches)
    checked = _check_recorded("tools chaos", recording, {})
    t0 = time.perf_counter()
    shard_grid = chaos_tool.run_shard_grid(seed, backend=backend)
    shard_seconds = time.perf_counter() - t0
    bad = {k: shard_grid["counts"][k] for k in VIOLATIONS if shard_grid["counts"][k]}
    if not shard_grid["ok"] or bad:
        raise AssertionError(f"tools shard chaos: {shard_grid['counts']} {json.dumps(shard_grid['violations'])[:2000]}")
    return {
        "runs": grid["runs"], "counts": grid["counts"], "faults": grid["total_faults_injected"],
        "bitflips": grid["bitflips_injected"], "seconds": seconds, "launches": launches, "checked": checked,
        "shard": {"runs": shard_grid["runs"], "counts": shard_grid["counts"],
                  "faults": shard_grid["total_faults_injected"], "seconds": shard_seconds},
    }


def _crash_tools(seed: int, backend, built: dict, root: str) -> dict:
    """`tools.crashtest` with children on the card: the range kill grid (4
    points, both flavours, 4 points at once, so their children start
    together and must map the one build the parent made) over the cut world
    at chunk 16, and beside it one point each of the compaction, registry,
    backfill and SIGTERM-stream grids; every point must resume
    byte-identical (or tear typed), and the resumed bundles verify on the
    card. The parent and every child take the unfused scan
    (``IPC_SCAN_FUSED_MATCH=0``), so each range walk's fingerprint mask runs
    on the card; the references the points resume to record their mask
    calls, which are held against the plain mask, and equal the references
    that the host's fused C walk computes, byte for byte."""
    n_pairs, receipts, events, match_rate = TOOLS_WORLD
    shape = {"pairs": n_pairs, "chunk_size": CRASH_CHUNK, "receipts": receipts, "events": events,
             "match_rate": match_rate, "record_workers": 1}
    rng = random.Random(f"{seed}:crash")
    work = os.path.join(root, "crashtest")
    os.makedirs(work)
    t0 = time.perf_counter()
    dev = backend.device.type
    host_refs = {"range": crashtest_tool.range_reference(shape, "cpu"),
                 "backfill": crashtest_tool.backfill_reference(shape, "cpu")}
    n_windows = -(-n_pairs // CRASH_CHUNK)
    # each single point's draws, made before the points run side by side
    torn_sidecar, registry_at = rng.choice([13, 64, 200]), rng.randrange(12)
    backfill_at, backfill_torn = rng.randrange(n_windows - 1), rng.choice([1, 5, 11, 13, 64, 4096])
    with _env("IPC_SCAN_FUSED_MATCH", "0"):
        ref_recording = _RecordingBackend(backend)
        range_ref = crashtest_tool.range_reference(shape, backend=ref_recording)
        backfill_ref = crashtest_tool.backfill_reference(shape, backend=ref_recording)
        torch.cuda.synchronize()
        ref_checked = _check_recorded("tools crashtest references", ref_recording, {})
        if not ref_checked["event_match_mask_fp"]["calls"]:
            raise AssertionError(f"tools crashtest: the references made no mask call on the card: {ref_checked}")
        for label, ref in (("range", range_ref), ("backfill", backfill_ref)):
            if ref != host_refs[label]:
                raise AssertionError(f"tools crashtest: the card's {label} reference differs from the host's")

        def stream_point():
            reference, failure = crashtest_tool.stream_reference_run(shape, work, device=dev)
            if reference is None:
                return failure
            return crashtest_tool.sigterm_stream_run(reference, shape, 3, work, device=dev)

        points = {
            "compaction": lambda: crashtest_tool.compaction_crash_run(
                range_ref, shape, "torn_tmp", work, tag="c", torn_bytes=torn_sidecar, device=dev),
            "registry": lambda: crashtest_tool.registry_crash_run(
                dict(shape, pairs=12), registry_at, None, work, tag="r", device=dev),
            "backfill": lambda: crashtest_tool.backfill_crash_run(
                backfill_ref, shape, backfill_at, backfill_torn, work, tag="b", device=dev),
            "sigterm stream": stream_point,
        }
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(points)) as pool:
            futures = {name: pool.submit(fn) for name, fn in points.items()}
            grid = crashtest_tool.run_grid(
                seed, points=CRASH_POINTS, n_pairs=n_pairs, chunk_size=CRASH_CHUNK, receipts=receipts,
                events=events, match_rate=match_rate, device=dev, workers=CRASH_POINTS, reference=range_ref,
            )
            singles = {name: f.result() for name, f in futures.items()}
    seconds = time.perf_counter() - t0
    if not grid["ok"]:
        raise AssertionError(f"tools crashtest: {grid['counts']} {json.dumps(grid['violations'])[:3000]}")
    want = {"compaction": "identical", "registry": "identical", "backfill": "identical",
            "sigterm stream": "typed_tear"}
    wrong = {k: v for k, v in singles.items() if v["outcome"] != want[k]}
    if wrong:
        raise AssertionError(f"tools crashtest: {json.dumps(wrong)[:3000]}")
    # the children started together and mapped the parent's one build
    mapped = {name: set(paths) for name, paths in grid["libraries"].items()}
    for name, path in singles["backfill"].get("libraries", {}).items():
        mapped.setdefault(name, set()).add(path)
    expected = {name: {str(info["path"])} for name, info in built.items()}
    if mapped != expected:
        raise AssertionError(f"tools crashtest: children mapped {mapped}, the parent built {expected}")
    # every resumed bundle is one of these bytes: verify them on the card
    recording = _RecordingBackend(backend)
    _reset_counts()
    verdicts = []
    for label, raw in (("range", range_ref), ("backfill", backfill_ref)):
        bundle = UnifiedProofBundle.from_json(raw)
        result = verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True,
                                     cid_backend=recording)
        if not bundle.event_proofs or not result.all_valid():
            raise AssertionError(f"tools crashtest: the resumed {label} bundle does not verify")
        verdicts.append(len(bundle.event_proofs))
    torch.cuda.synchronize()
    launches = _counts()
    _require_blake2b("tools crashtest verify", launches)
    return {
        "points": grid["points"], "kill_points": grid["kill_points"], "n_chunks": grid["n_chunks"],
        "counts": grid["counts"], "singles": {k: v["outcome"] for k, v in singles.items()},
        "children": 2 * grid["points"] + 8, "libraries": {k: sorted(v) for k, v in mapped.items()},
        "seconds": seconds,
        "proofs_verified": verdicts, "launches": launches, "references_checked": ref_checked,
        "checked": _check_recorded("tools crashtest verify", recording, {}),
    }


def _soak_tools(seed: int, backend) -> dict:
    """`tools.soak --quick` over event, storage, shapes, codec and range,
    seeded from ``--seed``, with the batched paths on the card."""
    recording = _RecordingBackend(backend)
    _reset_counts()
    t0 = time.perf_counter()
    phase_seconds = soak_tool.run_phases(seed, SOAK_PHASES, True, recording)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _require_blake2b("tools soak", launches)
    if not sum(launches[name] for name in KECCAK_CLASSES):
        raise AssertionError(f"tools soak launched no keccak kernel: {launches}")
    return {"phases": list(SOAK_PHASES), "phase_seconds": phase_seconds, "seconds": seconds,
            "launches": launches, "checked": _check_recorded("tools soak", recording, {})}


def _offline_tools(registry_log: str, trace_path: str, n_spans: int, root: str) -> dict:
    """``auditview verify / prove / diff`` over phase 20's registry log and
    ``traceview`` over phase 5c's Chrome trace, through their ``main`` as
    ``python -m`` runs them: each exits 0; a copy of the log with one byte
    flipped fails ``verify`` (exit 1)."""
    t0 = time.perf_counter()
    rc, text = _tool_main(auditview_tool.main, ["verify", registry_log, "--json"])
    verdict = json.loads(text)
    if rc != 0 or not verdict["ok"] or not verdict["records"]:
        raise AssertionError(f"auditview verify: exit {rc}, {text[:500]}")
    entries, _torn = auditview_tool.load_log(registry_log)
    serve_seqs = [i for i, (rec, _p, _o) in enumerate(entries) if rec.get("kind") == "serve"]
    digest = entries[serve_seqs[len(serve_seqs) // 2]][0]["digest"]
    rc_prove, text_prove = _tool_main(auditview_tool.main, ["prove", registry_log, "--digest", digest,
                                                            "--root", verdict["root"], "--json"])
    old = verdict["records"] // 2
    rc_diff, text_diff = _tool_main(auditview_tool.main, ["diff", registry_log, "--old-size", str(old), "--json"])
    if (rc_prove, rc_diff) != (0, 0):
        raise AssertionError(f"auditview: prove exit {rc_prove} ({text_prove[:300]}), diff exit {rc_diff}")
    flipped = os.path.join(root, "flipped.log")
    raw = bytearray(open(registry_log, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(flipped, "wb") as fh:
        fh.write(raw)
    rc_flip, text_flip = _tool_main(auditview_tool.main, ["verify", flipped])
    if rc_flip != 1 or not text_flip.startswith("FAIL"):
        raise AssertionError(f"auditview verify of a flipped byte: exit {rc_flip}, {text_flip[:300]}")
    audit_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_trace, text_trace = _tool_main(traceview_tool.main, [trace_path, "--json"])
    summary = json.loads(text_trace)
    rc_human, _ = _tool_main(traceview_tool.main, [trace_path])
    if (rc_trace, rc_human) != (0, 0) or summary["n_events"] != n_spans or not summary["traces"]:
        raise AssertionError(f"traceview: exit {rc_trace} / {rc_human}, {summary.get('n_events')} of {n_spans} spans")
    widest = summary["traces"][0]
    return {
        "audit": {"records": verdict["records"], "kinds": verdict["kinds"], "seconds": audit_seconds,
                  "flipped_exit": rc_flip, "diff_appended": len(json.loads(text_diff)["appended"])},
        "trace": {"spans": summary["n_events"], "traces": summary["n_traces"], "root": widest["root"],
                  "critical_path": [hop["name"] for hop in widest["critical_path"]],
                  "seconds": time.perf_counter() - t0},
    }


def tools_phase(device, seed: int, built: dict, registry_log: str, trace_path: str, n_spans: int,
                root: str) -> dict:
    """Phase 31: the port's fault-injection and audit tools driving the port
    on the card — chaos, crashtest, the quick soak, auditview and
    traceview — each failing the run on any violation."""
    backend = get_backend("gpu", device=device)
    out = {}
    for label, run in (
        ("chaos", lambda: _chaos_tools(seed, backend)),
        ("crashtest", lambda: _crash_tools(seed, backend, built, root)),
        ("soak", lambda: _soak_tools(seed, backend)),
        ("offline", lambda: _offline_tools(registry_log, trace_path, n_spans, root)),
    ):
        t0 = time.perf_counter()
        out[label] = run()
        out[label]["wall_s"] = time.perf_counter() - t0
        _log(f"tools {label} ({out[label]['wall_s']:.1f} s)")
    out["launches"] = out["chaos"]["launches"]
    return out


_PYTEST_COUNTS = re.compile(r"(\d+) (passed|failed|skipped|errors?|deselected)")


def _gate_run(label: str, argv: "list[str]", env: "dict[str, str] | None" = None, timeout: int = 600):
    """Run ``python argv`` from the checkout's root; (seconds, output).
    Fails the phase on a non-zero exit, quoting the output's tail."""
    here = os.path.dirname(os.path.abspath(__file__))
    run_env = dict(os.environ, PYTHONPATH=here, **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=here, env=run_env, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"static gates, {label}: exit {proc.returncode}\n{text[-6000:]}")
    return seconds, text


def static_gates_phase() -> dict:
    """Phase 32: the port's static gates on the card's host — the port's
    linter, clean; ``build_native_san --strict``, its host half (the
    sanitized C extensions under the native soak phases) and its CUDA half
    (every kernel entry at edge sizes under guard bands and
    ``compute-sanitizer`` memcheck and initcheck, each equal to its plain
    version); and the card-only tests under ``IPC_LOCKDEP=1``, passing
    with no ``LockOrderError``. Every part runs in a child process."""
    out: dict = {"seconds": {}}
    seconds, text = _gate_run("ipclint", ["-m", "ipc_proofs_tpu_torch.tools.ipclint"])
    m = re.search(r"ipclint: clean \((\d+) files\)", text)
    if m is None:
        raise AssertionError(f"static gates, ipclint: no clean line\n{text[-2000:]}")
    out["seconds"]["ipclint"], out["files_linted"] = seconds, int(m.group(1))

    _, text = _gate_run("sanitizer", ["-m", "ipc_proofs_tpu_torch.tools.build_native_san", "--strict"])
    if "SOAK CLEAN" not in text or text.count(".san.so") != 2:
        raise AssertionError(f"static gates, host half: no sanitized soak\n{text[-4000:]}")
    for half in ("host", "cuda"):
        out["seconds"][f"sanitizer {half} half"] = float(re.search(rf"{half} half ([0-9.]+) s", text).group(1))
    out["sanitized_libraries"] = re.findall(r"built (\S+\.san\.so)", text)
    m = re.search(r"^build_native_san: cuda summary (\{.*\})$", text, re.M)
    if m is None:
        raise AssertionError(f"static gates, cuda half: no summary\n{text[-4000:]}")
    cuda = json.loads(m.group(1))
    guard = cuda["guard"]
    cases = ([k[0] for k in KERNELS + KECCAK_KERNELS + MATCH_KERNELS] + [c[0] for c in BLAKE2B_BLOCK_CASES[1:]]
             + [c[0] for split in BLAKE2B_SPLIT_CASES.values() for c in split[1:]] + list(FULL_SHARE_CASES)
             + list(SLICE_CASES))
    if sorted(guard) != sorted(cases):
        raise AssertionError(f"static gates, cuda half: entries {sorted(guard)}")
    for entry, row in guard.items():
        if row["violations"] or row["mismatches"] or not row["launches"]:
            raise AssertionError(f"static gates, cuda half: {entry} {row}")
    for tool, row in cuda["tools"].items():
        if row["status"] == "ran" and row["errors"] != 0:
            raise AssertionError(f"static gates, compute-sanitizer {tool}: {row}")
    out["sanitizer"] = cuda
    # the children's launches (this process counts none of them)
    out["launches"] = {name: sum(row["launches"] for case, row in guard.items() if case.split("[")[0] == name)
                       for name in _counts()}

    seconds, text = _gate_run(
        "cuda tests under lockdep",
        ["-m", "pytest", "-m", "cuda", "tests/test_torch_cuda.py", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly"],
        env={"IPC_LOCKDEP": "1"}, timeout=900,
    )
    counts = {kind: int(n) for n, kind in _PYTEST_COUNTS.findall(text.splitlines()[-1])}
    if "LockOrderError" in text or not counts.get("passed") or counts.get("failed") or counts.get("skipped"):
        raise AssertionError(f"static gates, cuda tests under lockdep: {counts}\n{text[-4000:]}")
    out["seconds"]["cuda tests under lockdep"], out["cuda_tests"] = seconds, counts
    return out


# -- the repo's bench (slice 15) ---------------------------------------------

BENCH_ARTIFACT = "bench_torch_runs/BENCH_torch_r01.json"
# phase 33's legs, the reference leg's keys for each (``bench.py``'s
# return dicts; the CPU tests hold this table against it), and the kernels
# each leg's child must launch
BENCH_LEG_KEYS = {
    "e2e": (
        "metric", "value", "unit", "platform", "devices", "host_cores", "host_cores_affinity",
        "scan_threads", "record_workers", "verify_workers", "effective_threads", "native_scan_threads",
        "pipeline_depth", "pipeline_chunk", "events_per_sec_e2e", "proofs", "stages_ms", "stages_wall_ms",
        "stages_overlap", "gen_verify_overlap", "overlap_efficiency", "serial_proofs_per_sec",
        "serial_e2e_reps_s", "pipeline_speedup_vs_serial", "e2e_policy", "e2e_reps_s", "_platform",
    ),
    "kernel": ("device_mask_kernel_events_per_sec", "_platform"),
    "cid": ("witness_cid_kernel_per_sec", "witness_cid_kernel", "_platform"),
    "onchip": (
        "device_linearity_Nchip", "batch_verify_speedup", "onchip_devices", "onchip_match_events",
        "onchip_verify_blocks", "onchip_device_calls", "verify_tuned_speedup", "verify_autotune_scalar_only",
        "verify_autotuned_min_bytes", "_platform",
    ),
}
BENCH_LEG_LAUNCHES = {  # each group: at least one of its kernels
    "e2e": (("blake2b256_single_block", "blake2b256_two_block", "blake2b256_blocks"),),
    "kernel": (("match_pipeline",),),
    "cid": (("blake2b256_two_block",),),
    "onchip": (("event_match_mask_fp",), ("event_match_mask_fp_sharded",), ("blake2b256_blocks",)),
}
BENCH_HEADLINES = {
    "e2e": "value", "kernel": "device_mask_kernel_events_per_sec", "cid": "witness_cid_kernel_per_sec",
    "onchip": "batch_verify_speedup",
}


def bench_phase() -> dict:
    """Phase 33: four legs of ``bench_torch.py --quick`` on the card, each
    in a child under its leg's own watchdog (the e2e leg probes the card as
    ``--platform auto`` does; the others are given ``--platform cuda``, as
    the orchestrator gives every leg), their keys held against the
    reference's and their children's launches read; then the port's
    schema checker over the committed artifact."""
    import bench_torch

    here = os.path.dirname(os.path.abspath(__file__))
    quick = bench_torch._parse_args(["--quick"])
    out: dict = {"legs": {}, "launches": {name: 0 for name in _counts()}}
    for leg, keys in BENCH_LEG_KEYS.items():
        argv = [sys.executable, os.path.join(here, "bench_torch.py"), "--leg", leg, "--quick"]
        if leg != "e2e":
            argv += ["--platform", "cuda"]
        timeout = bench_torch._leg_timeout(leg, quick)
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=timeout,
                              env=dict(os.environ, PYTHONPATH=here))
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"bench, leg {leg}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        if result.get("_platform") != "cuda" or sorted(result) != sorted(keys):
            raise AssertionError(f"bench, leg {leg}: platform {result.get('_platform')!r}, keys "
                                 f"{sorted(set(result) ^ set(keys))} differ from the reference leg's")
        m = re.search(r"^bench: kernel launches (\{.*\})$", proc.stderr, re.M)
        if m is None:
            raise AssertionError(f"bench, leg {leg}: no launch line\n{proc.stderr[-2000:]}")
        launches = json.loads(m.group(1))
        idle = [group for group in BENCH_LEG_LAUNCHES[leg] if not any(launches.get(name) for name in group)]
        if idle:
            raise AssertionError(f"bench, leg {leg}: did not launch {idle}: {launches}")
        for name, n in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + n
        probe = re.search(r"^bench: card probe OK → (.*)$", proc.stderr, re.M)
        out["legs"][leg] = {
            "seconds": round(seconds, 1), "timeout_s": timeout, BENCH_HEADLINES[leg]: result[BENCH_HEADLINES[leg]],
            "launches": {k: v for k, v in launches.items() if v},
            **({"probe": probe.group(1)} if probe else {}),
        }
    if "probe" not in out["legs"]["e2e"]:
        raise AssertionError("bench, leg e2e: no card probe line")
    proc = subprocess.run([sys.executable, "-m", "ipc_proofs_tpu_torch.tools.check_bench_schema", BENCH_ARTIFACT],
                          cwd=here, capture_output=True, text=True, timeout=120, env=dict(os.environ, PYTHONPATH=here))
    if proc.returncode != 0 or proc.stdout.strip() != f"{BENCH_ARTIFACT}: ok":
        raise AssertionError(f"bench, check_bench_schema: exit {proc.returncode}\n{proc.stdout[-2000:]}")
    out["schema"] = proc.stdout.strip()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pairs", type=int, default=4096)
    parser.add_argument("--messages", type=int, default=1 << 20)
    parser.add_argument("--pure-pairs", type=int, default=256)
    parser.add_argument("--pure-contracts", type=int, default=16)
    # the child process of the pure-Python phase
    parser.add_argument("--pure-python-paths", action="store_true", help=argparse.SUPPRESS)
    # the child of the HTTP phases' client load (no device)
    parser.add_argument("--http-clients", help=argparse.SUPPRESS)
    # the child of the standing-query phase's webhook endpoint (no device)
    parser.add_argument("--webhook-receiver", help=argparse.SUPPRESS)
    parser.add_argument("--contracts", type=int, default=CONTRACTS, help=argparse.SUPPRESS)
    parser.add_argument("--slots", type=int, default=SLOTS_PER_CONTRACT, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.http_clients:
        _http_clients_child(args.http_clients)
        return 0
    if args.webhook_receiver:
        _webhook_receiver_child(args.webhook_receiver)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    if args.pure_python_paths:
        print(json.dumps(pure_python_paths(args.pairs, args.contracts, args.slots)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    _log(f"card: {smi}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    _log(f"host: {_host_info()} (native scanner built from {load_scan_ext().__file__})")

    built = build_libraries(KERNEL_LIBRARIES + (MATCH_STUDY, B2B_STUDY))
    for name, info in built.items():
        _log(f"build {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  ptxas: {line.strip()}")
    per_compression = sass_per_compression(built["blake2b"]["path"])
    for loader, counts in per_compression.items():
        _log(f"sass blake2b {loader} kernel: thread-instructions issued per compression {counts} "
             f"(the algorithm's {BLAKE2B_OPS})")
    per_permutation = sass_per_permutation(built["keccak"]["path"])
    for loader, counts in per_permutation.items():
        _log(f"sass keccak256_kernel<{loader}>: instructions issued per absorbed block {counts} "
             f"(the algorithm's {KECCAK_OPS})")

    record_launch_rows()
    b2b_cases = _kernel_cases(args.messages, args.seed, device)
    kernels = kernel_phase(b2b_cases, blake2b, BLAKE2B_OPS, per_compression)
    crossover = blocks_crossover(next(c for c in b2b_cases if c.name == "blake2b256_blocks"))
    kernels["blake2b256_blocks"]["crossover"] = crossover
    _log(f"blake2b256_blocks, one and four lanes a message, ms by rows on {smi} "
         f"(the wrapper takes four up to {blake2b.QUAD_ROWS_MAX}): {json.dumps(crossover)}")
    for case in b2b_cases:
        if case.name != "blake2b256_blocks":
            kernels[case.name]["crossover"] = split_crossover(case)
            _log(f"{case.name}, one and four lanes a message, ms by rows on {smi} (the wrapper takes four up to "
                 f"{blake2b.quad_rows_max(case.name)}): {json.dumps(kernels[case.name]['crossover'])}")
    del b2b_cases
    kernels.update(
        kernel_phase(
            _keccak_cases(args.messages, args.messages // 4, args.seed, device),
            keccak,
            KECCAK_OPS,
            per_permutation,
        )
    )
    paths: dict = {}
    seconds: dict = {}

    def run(label, fn, *fn_args):
        t0 = time.perf_counter()
        paths[label] = fn(*fn_args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        _log(f"{label} ({seconds[label]} s): {json.dumps(paths[label])}")

    run("device match pipeline", device_match_phase, device, smi)
    run("cid bench", cid_bench_phase, args.seed, smi)
    world = event_world(args.pairs)
    run("event path", event_path, world, device)
    run("overlapped event path", overlapped_path, world, device, paths["event path"]["proofs_per_s"])
    root_dir = tempfile.TemporaryDirectory()  # phase 5c's trace stays for phase 31
    run("traced", traced_path, world, device, root_dir.name)
    run("mesh range", mesh_range, world, device)
    run("multihost", multihost_phase, device)
    with root_dir as root:
        cold_world = (world[0], world[1][:COLD_PAIRS], None)
        run("cold read", cold_read_path, cold_world, device, root)
        run("warm restart", warm_restart, cold_world, root)
        run("lying disk", lying_disk, cold_world, root, args.seed)
        run("pool", pool_path, world, args.seed)
        del cold_world  # the event world stays for the serve generate phase
        run("storage path", storage_path, CONTRACTS, SLOTS_PER_CONTRACT, args.seed, device)
        run("mixed range", mixed_range, 64, device)
        run("resumable mixed range", resumable_mixed_range, 64, 16, device)
        pure = pure_python_phase(args.pure_pairs, args.pure_contracts, SLOTS_PER_CONTRACT)
        run("lying node", lying_node, LYING_NODE_PAIRS, root, args.seed)
        run("mixed-multihash sweep", mixed_sweep, root, args.seed)
        chain = cli_world(args.pairs)
        cut = _chain_prefix(chain, min(CLI_RANGE_PAIRS, args.pairs))
        run("cli range", cli_range, cut, root)
        run("cli verify", cli_verify, cut, paths["cli range"]["bundle"], root, args.seed)
        run("cli cert", cli_cert, cut, root, args.seed)
        run("cli generate, vectors, demo", cli_rest, cut, root)
        del cut
        run("cli range --mesh-devices 1", cli_mesh_range, chain, root)
        run("follower", follower_path, chain, root)
        run("cli_pool", cli_pool_range, chain, root)
        del chain
        # the tuned crossover applies to every later verify call of the
        # process; the serve phases after it verify through
        # verify_proof_bundle, whose CID batches do not go through the lane
        run("autotune", autotune_phase, root)
        run("serve verify", serve_verify_phase, device)
        run("serve generate", serve_generate_phase, world, device, root)
        run("http verify", http_verify_phase, device)
        run("http generate", http_generate_phase, world, device, root)
        run("durable", durable_phase, world, device, root)
        run("replication", replication_phase, world, device, root)
        run("witness diet", witness_diet_phase, device)
        run("registry", registry_phase, device, root)
        run("http overload", http_overload_phase, device)
        run("cli serve", cli_serve_phase, device, root)
        run("standing queries", subs_phase, world, device, root)
        run("backfill", backfill_phase, world, device, root)
        run("cluster", cluster_phase, world, device, root)
        del world
        run("cli cluster", cli_cluster_phase, device, root)
        package_built = {name: built[name] for name in KERNEL_LIBRARIES}  # what the children map
        run("tools", tools_phase, device, args.seed, package_built, paths["registry"]["log"], paths["traced"]["chrome"],
            paths["traced"]["trace.spans_recorded"], root)
    run("static gates", static_gates_phase)
    run("bench", bench_phase)
    cli_paths = paths.pop("cli generate, vectors, demo")
    launch_counts = {label: path["launches"] for label, path in paths.items()}
    launch_counts["event path, unfused"] = paths["event path"]["unfused"]["launches"]
    launch_counts["overlapped event path, unfused"] = paths["overlapped event path"]["unfused"]["launches"]
    launch_counts["resumable mixed range, resumed"] = paths["resumable mixed range"]["resumed_launches"]
    launch_counts["event path, pure Python"] = pure["event"]["launches"]
    launch_counts["storage path, pure Python"] = pure["storage"]["launches"]
    launch_counts["warm restart, sweep"] = paths["warm restart"]["sweep_launches"]
    launch_counts["cold read, default crossover"] = paths["cold read"]["default_crossover"]["launches"]
    launch_counts["cli range, resumed"] = paths["cli range"]["resumed"]["launches"]
    launch_counts["cli verify, f3 cert"] = paths["cli verify"]["f3"]["launches"]
    launch_counts["cli generate"] = cli_paths["generate"]["launches"]
    launch_counts["cli demo"] = cli_paths["demo"]["launches"]
    launch_counts["mesh range, mesh of 1"] = paths["mesh range"]["mesh of 1"]["launches"]
    launch_counts["mesh range, overlapped"] = paths["mesh range"]["overlapped"]["launches"]
    launch_counts["serve verify, cids"] = paths["serve verify"]["cids_launches"]
    launch_counts["serve verify, sequential"] = paths["serve verify"]["sequential_launches"]
    launch_counts["serve range window"] = paths["serve generate"]["window_launches"]
    launch_counts["witness aggregate verify"] = paths["witness diet"]["aggregate_launches"]
    launch_counts["http verify, cids"] = paths["http verify"]["cids_launches"]
    launch_counts["http verify, blocks_frame"] = paths["http verify"]["extra"]["blocks_frame"]["launches"]
    launch_counts["http verify, claims"] = paths["http verify"]["extra"]["claims"]["launches"]
    launch_counts["http generate, stream"] = paths["http generate"]["stream_launches"]
    launch_counts["http generate, verify"] = paths["http generate"]["verify_launches"]
    launch_counts["subs push"] = launch_counts.pop("standing queries")
    launch_counts["subs verify"] = paths["standing queries"]["verify_launches"]
    launch_counts["backfill stream"] = paths["backfill"]["stream_launches"]
    launch_counts["cli backfill"] = paths["backfill"]["cli_launches"]
    launch_counts["cluster, stream"] = paths["cluster"]["stream_launches"]
    launch_counts["cluster verify"] = paths["cluster"]["verify_launches"]
    launch_counts["cluster load"] = paths["cluster"]["load_launches"]
    launch_counts["cluster hostkill"] = paths["cluster"]["hostkill_launches"]
    launch_counts["cluster backfill"] = paths["cluster"]["backfill_launches"]
    launch_counts["cli cluster, 1 shard"] = paths["cli cluster"]["one_shard_launches"]
    launch_counts["tools chaos"] = launch_counts.pop("tools")
    launch_counts["tools crashtest verify"] = paths["tools"]["crashtest"]["launches"]
    launch_counts["tools soak"] = paths["tools"]["soak"]["launches"]

    kernels.update(paths["device match pipeline"]["kernels"])
    # the row counts the paths launched the split kernels at, and those of
    # them up to the crossover sweep's last that it did not time
    split_names = ("blake2b256_single_block", "blake2b256_two_block")
    for name, rows_of in launch_rows_by_path(launch_counts, split_names).items():
        rows_of["unswept"] = [int(n) for n in rows_of["rows"] if int(n) <= max(SPLIT_SWEEP)
                              and int(n) not in SPLIT_SWEEP]
        kernels[name]["launch_rows"] = rows_of
        _log(f"{name} launches over all paths by rows (power-of-two bins): {json.dumps(rows_of)}")
    # blake2b256_blocks at the event path's own multi-block witness rows
    wmb = paths["event path"]["witness_multi_block"]
    w_bytes_ms, w_ops_ms = wmb["bytes"] / HBM_BYTES_PER_S * 1e3, _ops_ms(BLAKE2B_OPS, wmb["units"])
    kernels["blake2b256_blocks"]["witness"] = {
        "rows": wmb["rows"], "ms": wmb["ms"], "device_ms": wmb["device_ms"],
        "one_lane_ms": wmb["one_lane_ms"], "one_lane_device_ms": wmb["one_lane_device_ms"],
        "bound_ms": max(w_bytes_ms, w_ops_ms), "bound_by": "bytes" if w_bytes_ms >= w_ops_ms else "operations",
        "issued_bound_ms": max(w_bytes_ms, _ops_ms(per_compression[wmb["instantiation"]], wmb["units"])),
        "instantiation": wmb["instantiation"],
    }
    _log(f"blake2b256_blocks at the event path's witness rows on {smi}: "
         f"{json.dumps(kernels['blake2b256_blocks']['witness'])} (compressions a row: {json.dumps(wmb['compressions'])})")
    # the single- and two-block kernels at the event path's witness rows
    for name, w in paths["event path"]["witness_small_blocks"].items():
        w_bytes_ms, w_ops_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3, _ops_ms(BLAKE2B_OPS, w["units"])
        kernels[name]["witness"] = dict(
            {key: w[key] for key in w if key not in ("units", "bytes") and "max_abs_err" not in key},
            bound_ms=max(w_bytes_ms, w_ops_ms), bound_by="bytes" if w_bytes_ms >= w_ops_ms else "operations",
            issued_bound_ms=max(w_bytes_ms, _ops_ms(per_compression[b2b_instantiation(w["padded_rows"], name)],
                                                    w["units"])),
            instantiation=b2b_instantiation(w["padded_rows"], name),
        )
        _log(f"{name} at the event path's witness rows on {smi}: {json.dumps(kernels[name]['witness'])}")
    rows = []
    for name, replaces, source, keys in [(k[0], k[1], SOURCE, (k[0],)) for k in KERNELS] + [
        (k[0], k[1], KECCAK_SOURCE, (k[0],)) for k in KECCAK_KERNELS
    ] + [(k[0], k[1], MATCH_SOURCE, k[2]) for k in MATCH_KERNELS]:
        k = kernels[name]
        per_path = {label: sum(counts.get(key, 0) for key in keys) for label, counts in launch_counts.items()}
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": per_path[OWN_PATH[name]],
            "launches_by_path": per_path,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no PyTorch call computes blake2b or keccak-256
            "library_ms": k.get("library_ms"),
        }
        row.update({key: k[key] for key in ("device_ms", "library_device_ms", "witness", "crossover", "floor_ms",
                                            "streaming", "launch_rows", "bound_ms_64", "passes", "designs")
                    if key in k})
        rows.append(row)
        issued = f", on the build's SASS {k['issued_bound_ms']}" if "issued_bound_ms" in k else ""
        _log(
            f"{name}: rows={k['rows']} kernel_ms={k['ms']} plain_ms={k['plain_ms']} "
            f"bound_ms={k['bound_ms']} ({k['bound_by']}{issued}) library_ms={row['library_ms']} "
            f"device_ms={k.get('device_ms')} library_device_ms={k.get('library_device_ms')} launches={per_path}"
        )
    _log(f"pure-Python paths: {json.dumps(pure)}")
    event, storage = paths["event path"], paths["storage path"]
    _log(
        f"event path on {smi}: {event['proofs']} proofs, {event['proofs_per_s']} proofs/s, "
        f"{event['host']}"
    )
    overlapped = paths["overlapped event path"]
    budget = overlapped["budget"]
    _log(
        f"overlapped event path on {smi}: {overlapped['proofs']} proofs in {overlapped['chunks']} chunks "
        f"of {overlapped['chunk_size']} pairs, wall {overlapped['wall_ms']} ms, "
        f"{overlapped['proofs_per_s']} proofs/s (serial {overlapped['serial_proofs_per_s']} proofs/s), "
        f"overlap_efficiency {overlapped['overlap_efficiency']}"
    )
    _log(
        "overlapped stage busy ms: "
        + ", ".join(f"{k} {overlapped['stage_busy_ms'].get(k)}" for k in OVERLAP_STAGES)
    )
    _log(
        f"thread budget: total {budget['total']} ({budget['source']}), scan {budget['scan_workers']}, "
        f"record {budget['record_workers']}, verify {budget['verify_workers']}, "
        f"native {budget['native_scan_threads']} (scan x native = "
        f"{budget['scan_workers'] * budget['native_scan_threads']} <= {budget['total']})"
    )
    _log(
        f"overlapped verify_chunk ms summed over chunks: {overlapped['verify_chunk_ms']}; "
        f"the same chunks verified alone, one after another: {overlapped['verify_chunks_alone_ms']}"
    )
    _log(f"overlapped launches: {overlapped['launches']}")
    _log(
        f"overlapped profiled repeat: busy {overlapped['profiled_run']['busy_ms']} ms of "
        f"{overlapped['profiled_run']['wall_ms']} ms wall"
    )
    _log(
        f"overlapped unfused rerun: {overlapped['unfused']['proofs_per_s']} proofs/s, "
        f"counters {overlapped['unfused']['counters']}, "
        f"fingerprint mask launches {overlapped['unfused']['launches']['event_match_mask_fp']}"
    )
    _log(
        f"storage path on {smi}: {storage['proofs']} proofs, {storage['proofs_per_s']} proofs/s, "
        f"{storage['host']}"
    )
    cold, warm = paths["cold read"], paths["warm restart"]
    _log(
        f"cold read on {smi}: {cold['proofs']} proofs over {cold['pairs']} pairs, wall {cold['wall_ms']} ms, "
        f"{cold['proofs_per_s']} proofs/s (in-memory serial {event['proofs_per_s']}); waves "
        f"{cold['waves']}; profiled repeat busy {cold['profiled_run']['busy_ms']} ms of "
        f"{cold['profiled_run']['wall_ms']} ms; at the default crossover "
        f"{cold['default_crossover']['proofs_per_s']} proofs/s"
    )
    _log(f"cold read counters: {json.dumps(cold['counters'])}")
    _log(
        f"warm restart on {smi}: sweep of {warm['blocks']} blocks ({warm['block_bytes']} bytes, "
        f"{warm['by_class']}) in {warm['sweep_verify_ms']} ms verify / {warm['open_ms']} ms open, "
        f"{warm['sweep_blocks_per_s']} blocks/s; warm generate {warm['generate_proofs_per_s']} proofs/s, "
        f"rpc.calls 0; at speculate depth 1 {warm['speculating']['proofs_per_s']} proofs/s, "
        f"rpc.calls {warm['speculating']['rpc_calls']}, "
        f"fetch.speculative_wants {warm['speculating']['counters'].get('fetch.speculative_wants', 0)}"
    )
    mixed = paths["mixed-multihash sweep"]
    _log(
        f"mixed-multihash sweep on {smi}: {mixed['blocks']} blocks, {mixed['flipped']} flipped, "
        f"{mixed['evicted']} evicted, verify {mixed['sweep_verify_ms']} ms, launches {mixed['launches']}"
    )
    c_range, c_verify, c_cert = paths["cli range"], paths["cli verify"], paths["cli cert"]
    _log(
        f"cli range on {smi}: {c_range['proofs']} event + {c_range['storage_proofs']} storage proofs over "
        f"{c_range['pairs']} pairs, wall {c_range['wall_ms']} ms, {c_range['proofs_per_s']} proofs/s, "
        f"tipset fetch {c_range['fetch_tipsets_ms']} ms, rpc.calls {c_range['rpc_calls']}, stage ms "
        f"{json.dumps(c_range['stage_busy_ms'])}; resumed in {c_range['resumed']['wall_ms']} ms with "
        f"{c_range['resumed']['chain_read_obj']} ChainReadObj"
    )
    _log(
        f"cli verify on {smi}: plain {c_verify['plain']['wall_ms']} ms, --f3-cert {c_verify['f3']['wall_ms']} ms "
        f"(power table of {c_verify['power_table_rows']}, EC chain of {c_verify['ec_chain']}), other epochs "
        f"{c_verify['other epochs']['wall_ms']} ms (exit 1)"
    )
    _log(
        f"cli cert on {smi}: {c_cert['certificates']} certificates, {c_cert['power_table_rows']} signers, "
        f"{c_cert['ms_per_certificate']} ms per certificate"
    )
    _log(f"autotune on {smi}: {json.dumps(paths['autotune']['record'])}")
    mesh = paths["mesh range"]
    _log(
        f"mesh range on {smi}: {mesh['proofs']} event + {mesh['storage_proofs']} storage proofs over "
        f"{mesh['pairs']} pairs; serial proofs/s: mesh of 1 {mesh['mesh of 1']['proofs_per_s']}, virtual mesh "
        f"of 4 {mesh['virtual mesh of 4']['proofs_per_s']}; overlapped over the virtual mesh "
        f"{mesh['overlapped']['proofs_per_s']} ({json.dumps(mesh['overlapped']['counters'])})"
    )
    for label, timing in paths["device match pipeline"]["timings"].items():
        _log(f"device match ({label}) on {smi}: {timing['pass_us']} us/pass, {timing['events_per_s']} events/s")
    _log(f"cid bench on {smi}: {paths['cid bench']['cids_per_s']} CIDs/s ({paths['cid bench']['kernel']})")
    _log(f"multihost on {smi}: {json.dumps(paths['multihost'])}")
    traced, pool, follow, cli_pool = paths["traced"], paths["pool"], paths["follower"], paths["cli_pool"]
    _log(
        f"traced on {smi}: {traced['proofs']} proofs, wall ms off {traced['wall_ms']['off']} / on "
        f"{traced['wall_ms']['on']}, overhead {traced['overhead_pct']} %, trace.spans_recorded "
        f"{traced['trace.spans_recorded']}, trace.spans_dropped {traced['trace.spans_dropped']}, "
        f"{traced['spans_per_proof']} spans a proof"
    )
    _log(
        f"pool on {smi}: proofs/s {json.dumps(pool['proofs_per_s'])}, integrity_overhead_pct "
        f"{pool['integrity_overhead_pct']}, recovery_ms {pool['recovery_ms']}, batch read ms "
        f"{json.dumps(pool['runs']['on']['batch_read_ms'])} (lane {pool['runs']['on']['lane_ms_per_call']} ms "
        f"a call), faulted counters "
        f"{json.dumps(pool['runs']['faulted']['counters'])}, launches {json.dumps(pool['launches'])}"
    )
    _log(
        f"follower on {smi}: {follow['heights']} heights in {follow['follow_ms']} ms "
        f"({follow['ms_per_height']} ms a height), {follow['blocks_prefetched']} blocks, waves "
        f"{json.dumps(follow['waves'])}, prefetch_hit_ratio {follow['prefetch_hit_ratio']}, range over the "
        f"warmed tier {follow['range_ms']} ms ({follow['range_rpc_calls']} RPC calls)"
    )
    _log(
        f"cli range --endpoints on {smi}: wall ms {json.dumps(cli_pool['wall_ms'])}, {cli_pool['spans']} spans, "
        f"reads by endpoint {json.dumps(cli_pool['reads_by_endpoint'])}"
    )
    serve, served = paths["serve verify"], paths["serve generate"]
    _log(
        f"serve verify on {smi}: {serve['requests']} requests, {serve['clients']} clients: "
        f"serve_batched_rps {serve['serve_batched_rps']} (CIDs on {serve['serve_batched_rps_cids']}), "
        f"serve_sequential_rps {serve['serve_sequential_rps']}, speedup {serve['serve_speedup_vs_sequential']}, "
        f"serve_p99_latency_ms {serve['serve_p99_latency_ms']}, serve_mean_batch {serve['serve_mean_batch']}, "
        f"serve.batches.verify {serve['serve.batches.verify']} (CIDs on {serve['runs']['cids']['batches']}); "
        f"blake2b launches {json.dumps(serve['launches'])}, CIDs on {json.dumps(serve['cids_launches'])}, "
        f"sequential {json.dumps(serve['sequential_launches'])}"
    )
    _log(
        f"serve generate on {smi}: {served['proofs']} proofs over {served['pairs']} pairs in "
        f"{served['wall_ms']} ms, {served['proofs_per_s']} proofs/s ({served['pairs_per_s']} pairs/s), "
        f"{served['batches']} batches (mean {served['mean_batch']}), p99 {served['p99_latency_ms']} ms, "
        f"journal_ms {served['journal_ms']}; launches {json.dumps(served['launches'])}, range window "
        f"{json.dumps(served['window_launches'])}"
    )
    diet, reg = paths["witness diet"], paths["registry"]
    _log(
        f"witness diet on {smi}: two-pass {diet['witness_two_pass_bytes']} B vs single-pass "
        f"{diet['witness_single_pass_bytes']} B ({diet['witness_reduction_pct']} %), bytes/proof "
        f"{json.dumps(diet['witness_bytes_per_proof'])}, delta ratio {diet['witness_delta_ratio']}, frame ratio "
        f"{json.dumps(diet['witness_compressed_ratio'])}; verify_aggregated of {diet['aggregate_claims']} claims "
        f"{diet['aggregate_verify_ms']} ms, launches {json.dumps(diet['aggregate_launches'])}"
    )
    _log(
        f"registry on {smi}: registry_append_overhead_pct {reg['registry_append_overhead_pct']} "
        f"({reg['registry_append_us']} us an append over {reg['serve_ms_per_request']} ms a request), "
        f"inclusion proof {reg['registry_inclusion_proof_ms']} ms at {reg['registry_chain_records']} records"
    )
    hv, hg, ho = paths["http verify"], paths["http generate"], paths["http overload"]
    dur, repl, cs = paths["durable"], paths["replication"], paths["cli serve"]
    _log(
        f"http verify on {smi}: {hv['requests']} requests, {hv['clients']} clients: HTTP {hv['http_rps']} req/s "
        f"(CIDs on {hv['http_rps_cids']}) against in-process {hv['inprocess_rps']} req/s in this run; "
        f"{hv['http_ms_per_request']} ms a request, p99 {hv['http_p99_ms']} ms; batches "
        f"{hv['runs']['plain']['batches']} / {hv['runs']['cids']['batches']}; blocks_frame "
        f"{hv['extra']['blocks_frame']['ms']} ms, 256 claims {hv['extra']['claims']['ms']} ms"
    )
    _log(
        f"http generate on {smi}: buffered {hg['runs']['buffered']['pairs_per_s']} pairs/s "
        f"({hg['runs']['buffered']['http_ms_per_request']} ms a request), stream "
        f"{hg['runs']['stream']['pairs_per_s']} pairs/s, stream_ttfb_ms {hg['stream_ttfb_ms']}, "
        f"warm_block_bytes_copied_per_resp {hg['warm_block_bytes_copied_per_resp']}, counters "
        f"{json.dumps(hg['runs']['stream']['counters'])}; launches {json.dumps(hg['launches'])}, "
        f"verify {json.dumps(hg['verify_launches'])}"
    )
    _log(
        f"http overload on {smi}: capacity {ho['capacity_rps']} req/s, goodput_ratio_at_2x "
        f"{ho['goodput_ratio_at_2x']}, shed_rate {ho['shed_rate']}, light_tenant_p99_ms_overload "
        f"{ho['light_tenant_p99_ms_overload']}, cancel_reclaim_pct {ho['cancel_reclaim_pct']}, answers "
        f"{json.dumps(ho['answers'])}"
    )
    _log(
        f"durable on {smi}: {dur['admitted']} admitted, resumed_jobs {dur['resumed_jobs']} in {dur['replay_ms']} ms, "
        f"launches {json.dumps(dur['launches'])}"
    )
    _log(
        f"replication on {smi}: {repl['segments_pulled']} segments, {repl['bytes_pulled']} bytes, "
        f"{repl['blocks_pulled']} blocks in {repl['pull_ms']} ms; get_many of {repl['get_many_blocks']} blocks "
        f"{repl['get_many_ms']} ms, launches {json.dumps(repl['launches'])}; replica_repairs "
        f"{repl['replica_repairs']}, inner reads after {repl['inner_reads_after_repair']}"
    )
    _log(
        f"cli serve on {smi}: up in {cs['start_ms']} ms, generate {cs['generate_rps']} req/s, verify "
        f"{cs['verify_rps']} req/s, serve.batches.verify {cs['serve.batches.verify']}, exit {cs['exit']}"
    )
    sqp, bf = paths["standing queries"], paths["backfill"]
    _log(
        f"standing queries on {smi}: {sqp['subscriptions']} subscriptions over {sqp['distinct_filters']} filters, "
        f"{sqp['tipsets']} tipsets finalized in {sqp['feed_ms']} ms ({sqp['ms_per_tipset']} ms a tipset); "
        f"{sqp['generations']} generations, {sqp['generations_per_s']} generations/s; "
        f"{sqp['webhook_deliveries']} webhook deliveries ({sqp['delta_deliveries']} deltas) in {sqp['push_ms']} ms, "
        f"{sqp['push_deliveries_per_s']} deliveries/s; {sqp['polled_deliveries']} polled; restart re-pushed "
        f"{sqp['refused_then_repushed']} in {sqp['restart_ms']} ms; verify of {sqp['bundles_verified']} bundles "
        f"{sqp['verify_ms']} ms; slo {json.dumps(sqp['slo'])}; counters {json.dumps(sqp['counters'])}; "
        f"stage busy ms, calls {json.dumps(sqp['stages'])}"
    )
    _log(
        f"backfill on {smi}: {bf['pairs']} pairs in {bf['windows']} windows of {bf['window_size']}: closed after "
        f"{bf['committed_before_close']} windows ({bf['killed_ms']} ms), resumed in {bf['resume_ms']} ms (first "
        f"chunk {bf['resume_first_chunk_ms']} ms), {bf['backfill_pairs_per_s']} pairs/s over both runs, "
        f"{bf['resumed_fresh_pairs_per_s']} pairs/s resumed; http {bf['http_pairs_per_s']} pairs/s, "
        f"stream_ttfb_ms {bf['stream_ttfb_ms']}, {bf['stream_chunks']} chunks in {bf['stream_polls']} polls; "
        f"cli {json.dumps(bf['cli'])}; stage busy ms, calls {json.dumps(bf['stages'])}"
    )
    clu, cc = paths["cluster"], paths["cli cluster"]
    hk = clu["hostkill"]
    _log(
        f"cluster on {smi}: {clu['proofs']} proofs over {clu['pairs']} pairs at chunk {clu['chunk_size']}: "
        f"proofs/s by shards {json.dumps(clu['proofs_per_s'])}, runs {json.dumps(clu['runs'])}; steal_events "
        f"{clu['steal_events']}; hostkill: kill_recovery_ms {hk['kill_recovery_ms']}, replica_repair_hit_rate "
        f"{hk['replica_repair_hit_rate']} ({hk['replica_repairs']} repaired of {hk['frames_flipped']} frames "
        f"flipped), aggregate_proofs_per_sec_2host {hk['aggregate_proofs_per_sec_2host']}, "
        f"cluster.shard_failovers {hk['shard_failovers']}; backfill {json.dumps(clu['backfill'])}"
    )
    _log(
        f"cli cluster on {smi}: {cc['requests']} generates from {cc['clients']} clients over {cc['pairs']} pairs: "
        f"aggregate_proofs_per_sec {cc['aggregate_proofs_per_sec']}, rps 4 shards {cc['cluster_rps_4shard']} / "
        f"1 shard {cc['cluster_rps_1shard']}, cluster_linearity_4shard {cc['cluster_linearity_4shard']}, "
        f"steal_events {cc['steal_events']}, up in {cc['runs']['4']['start_ms']} / {cc['runs']['1']['start_ms']} ms, "
        f"routed verify req/s {cc['runs']['4']['verify_rps']} / {cc['runs']['1']['verify_rps']}; "
        f"per shard {json.dumps({k: [v['generate_batches'], v['launches']] for k, v in cc['runs']['4']['per_shard'].items()})}"
    )
    tl = paths["tools"]
    ch, ct, sk, off = tl["chaos"], tl["crashtest"], tl["soak"], tl["offline"]
    _log(
        f"tools chaos on {smi}: {ch['runs']} runs over {TOOLS_WORLD[0]} pairs at rates {list(CHAOS_RATES)} in "
        f"{ch['seconds']:.1f} s, outcomes {json.dumps(ch['counts'])}, {ch['faults']} faults ({ch['bitflips']} "
        f"bit flips), launches {json.dumps(ch['launches'])}; shard grid {ch['shard']['runs']} runs in "
        f"{ch['shard']['seconds']:.1f} s, outcomes {json.dumps(ch['shard']['counts'])}"
    )
    _log(
        f"tools crashtest on {smi}: {ct['points']} range kill points {ct['kill_points']} over {ct['n_chunks']} "
        f"chunks, outcomes {json.dumps(ct['counts'])}; single points {json.dumps(ct['singles'])}; "
        f"{ct['children']} children in {ct['seconds']:.1f} s, mapped {json.dumps(ct['libraries'])}; resumed "
        f"bundles verified ({ct['proofs_verified']} proofs), launches {json.dumps(ct['launches'])}"
    )
    _log(
        f"tools soak on {smi}: --quick {sk['phases']} in {sk['seconds']:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in sk['phase_seconds'].items()})}), clean, launches "
        f"{json.dumps(sk['launches'])}"
    )
    _log(
        f"tools auditview / traceview on {smi}: {json.dumps(off['audit'])}; {json.dumps(off['trace'])}; "
        f"tool seconds {json.dumps({k: round(v['wall_s'], 1) for k, v in tl.items() if isinstance(v, dict) and 'wall_s' in v})}"
    )
    gates = paths["static gates"]
    _log(
        f"static gates on {smi}: ipclint clean over {gates['files_linted']} files; sanitized "
        f"{gates['sanitized_libraries']} clean under the native soak phases; kernel launches under the "
        f"sanitizer children {json.dumps(gates['sanitizer']['launches'])} (guard bands "
        f"{json.dumps(gates['sanitizer']['guard'])}), compute-sanitizer {json.dumps(gates['sanitizer']['tools'])}; "
        f"cuda tests under IPC_LOCKDEP=1 {json.dumps(gates['cuda_tests'])}; seconds "
        f"{json.dumps({k: round(v, 1) for k, v in gates['seconds'].items()})}"
    )
    bench_legs = paths["bench"]["legs"]
    _log(
        f"bench on {smi}: " + "; ".join(
            f"{leg} {row['seconds']} s (watchdog {row['timeout_s']:.0f} s), {BENCH_HEADLINES[leg]} "
            f"{row[BENCH_HEADLINES[leg]]}, launches {json.dumps(row['launches'])}" for leg, row in bench_legs.items()
        ) + f"; probe {bench_legs['e2e'].get('probe')}; {paths['bench']['schema']}"
    )
    _log(f"phase seconds: {json.dumps(seconds)}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
