"""The port's write-ahead job journals and chunk checkpoints against the JAX
package's: byte-identical frames, manifests and checkpoint names; the JAX
driver's checkpoints and journals resume in the port, and the port's in the
JAX driver; torn tails are discarded; a child process killed by
``IPC_JOURNAL_CRASH_AT`` (at a record boundary, and mid-record with
``IPC_JOURNAL_CRASH_TORN``) resumes to byte-identical bundles.

Every job is closed in the test body (tests/conftest.py fails a test that
leaks a journal fd).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import ipc_proofs_tpu.fixtures as ref_fixtures
from ipc_proofs_tpu.backend import get_backend as ref_get_backend
from ipc_proofs_tpu.jobs import job_manifest as ref_job_manifest
from ipc_proofs_tpu.jobs import read_journal as ref_read_journal
from ipc_proofs_tpu.jobs import resume_or_create as ref_resume_or_create
from ipc_proofs_tpu.jobs.journal import frame_record as ref_frame_record
from ipc_proofs_tpu.proofs import range as ref_range
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics
import ipc_proofs_tpu_torch.fixtures as fixtures
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.jobs import (
    JOBS_JOURNAL_NAME,
    JournalError,
    JournalWriter,
    job_manifest,
    read_journal,
    resume_or_create,
)
from ipc_proofs_tpu_torch.jobs.journal import frame_record, read_journal_entries, read_record_at
from ipc_proofs_tpu_torch.proofs import range as range_mod
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
from ipc_proofs_tpu_torch.utils.metrics import Metrics

ROOT = Path(__file__).resolve().parent.parent
SIG, TOPIC1, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001
WORLD = dict(n_pairs=8, receipts_per_pair=4, events_per_receipt=2, match_rate=0.3)
CHUNK = 2
N_CHUNKS = 4
STORAGE = [(ACTOR, TOPIC1, 0)]
BACKEND = get_backend("gpu", device="cpu")


@pytest.fixture(scope="module")
def worlds():
    store, pairs, _ = fixtures.build_range_world(**WORLD)
    ref_store, ref_pairs, _ = ref_fixtures.build_range_world(**WORLD)
    reference = ref_range.generate_event_proofs_for_range_chunked(
        ref_store, ref_pairs, RefSpec(SIG, TOPIC1, ACTOR), chunk_size=CHUNK,
        match_backend=ref_get_backend("cpu"), storage_specs=[RefSlotSpec(*s) for s in STORAGE],
    ).to_json()
    return store, pairs, ref_store, ref_pairs, reference


# --- framing -------------------------------------------------------------------

RECORDS = [
    {},
    {"t": "chunk", "chunk": 3, "digest": "abc", "bundle": {"blocks": []}, "verify": None},
    {"t": "verdict", "chunk": 0, "digest": None, "verify": [True, False]},
    {"b": "é" * 7, "a": [1, 2.5, None], "z": {"y": 1, "x": 2}},
    {"pad": "z" * 5000},
]


@pytest.mark.parametrize("index", range(len(RECORDS)))
def test_frame_record_bytes_equal_reference(index):
    assert frame_record(RECORDS[index]) == ref_frame_record(RECORDS[index])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journals_read_alike(tmp_path, writer):
    path = str(tmp_path / "j.bin")
    if writer == "port":
        w = JournalWriter(path)
        for obj in RECORDS:
            assert w.append(obj)
        w.close()
    else:
        from ipc_proofs_tpu.jobs import JournalWriter as RefWriter

        w = RefWriter(path)
        for obj in RECORDS:
            assert w.append(obj)
        w.close()
    assert read_journal(path) == ref_read_journal(path) == (RECORDS, os.path.getsize(path), False)
    entries, _, _ = read_journal_entries(path)
    assert [read_record_at(path, off) for _, off, _ in entries] == RECORDS


@pytest.mark.parametrize("cut", [1, 4, 11, 12, 13, 20, 60])
def test_torn_tail_is_recovered_alike(tmp_path, cut):
    """A frame cut anywhere, inside the header or the payload, is crash
    residue: both readers keep the good prefix and flag the tail."""
    path = tmp_path / "j.bin"
    partial = frame_record({"chunk": 1, "pad": "z" * 80})[:cut]
    path.write_bytes(frame_record({"chunk": 0}) + partial)
    expected = ([{"chunk": 0}], path.stat().st_size - cut, True)
    assert read_journal(str(path)) == ref_read_journal(str(path)) == expected


@pytest.mark.parametrize("damage", ["bit_flip", "bad_magic", "not_json"])
def test_corruption_raises_typed(tmp_path, damage):
    path = tmp_path / "j.bin"
    data = bytearray(frame_record({"chunk": 0, "bundle": "b" * 64}) + frame_record({"chunk": 1}))
    if damage == "bit_flip":
        data[12 + 10] ^= 0x40
    elif damage == "bad_magic":
        data[:4] = b"XXXX"
    else:
        import struct
        import zlib

        payload = b"\xff\xfenot json"
        data = bytearray(struct.pack("<4sII", b"IPJ1", len(payload), zlib.crc32(payload)) + payload)
    path.write_bytes(bytes(data))
    match = {"bit_flip": "checksum mismatch", "bad_magic": "bad journal magic", "not_json": "not valid JSON"}
    with pytest.raises(JournalError, match=match[damage]):
        read_journal(str(path))


def test_full_disk_degrades_and_the_job_still_commits_in_memory(tmp_path, worlds):
    store, pairs, _, _, _ = worlds

    class FullDisk:
        def write(self, data):
            raise OSError(28, os.strerror(28))

        def flush(self):
            pass

        def fileno(self):
            raise OSError(28, os.strerror(28))

        def close(self):
            pass

    metrics = Metrics()
    job = resume_or_create(str(tmp_path / "job"), job_manifest(b"spec", pairs, CHUNK), metrics=metrics)
    try:
        bundle = range_mod.generate_event_proofs_for_range(store, pairs[:2], _spec(), match_backend=BACKEND)
        assert job.commit_chunk(0, None, bundle)
        job._writer._fh.close()
        job._writer._fh = FullDisk()
        assert job.commit_chunk(1, None, bundle) is False
        assert job.degraded and job.has_chunk(0) and job.has_chunk(1)
    finally:
        job.close()
    assert metrics.counters["jobs.journal_failures"] == 1
    records, _, torn = read_journal(str(tmp_path / "job" / JOBS_JOURNAL_NAME))
    assert [r["chunk"] for r in records] == [0] and not torn


# --- request identity ------------------------------------------------------------


def _spec():
    return EventProofSpec(SIG, TOPIC1, ACTOR)


def test_request_identity_equals_reference(worlds):
    _, pairs, _, ref_pairs, _ = worlds
    ours = range_mod._request_spec_repr(_spec(), CHUNK, [MappingSlotSpec(*s) for s in STORAGE])
    ref = ref_range._request_spec_repr(RefSpec(SIG, TOPIC1, ACTOR), CHUNK, [RefSlotSpec(*s) for s in STORAGE])
    assert ours == ref
    assert job_manifest(ours, pairs, CHUNK) == ref_job_manifest(ref, ref_pairs, CHUNK)
    for k in range(N_CHUNKS):
        chunk, ref_chunk = pairs[k * CHUNK : (k + 1) * CHUNK], ref_pairs[k * CHUNK : (k + 1) * CHUNK]
        assert range_mod._chunk_checkpoint_digest(ours, chunk) == ref_range._chunk_checkpoint_digest(ref, ref_chunk)


def test_job_dir_is_bound_to_its_request(tmp_path, worlds):
    _, pairs, _, _, _ = worlds
    resume_or_create(str(tmp_path), job_manifest(b"one", pairs, CHUNK)).close()
    with pytest.raises(JournalError, match="different request"):
        resume_or_create(str(tmp_path), job_manifest(b"two", pairs, CHUNK))


# --- resume across packages ---------------------------------------------------------


def _run_port(driver, store, pairs, metrics, **artifact):
    kw = dict(chunk_size=CHUNK, match_backend=BACKEND, metrics=metrics,
              storage_specs=[MappingSlotSpec(*s) for s in STORAGE], **artifact)
    if driver == "chunked":
        return range_mod.generate_event_proofs_for_range_chunked(store, pairs, _spec(), **kw)
    if driver == "pipelined":
        return range_mod.generate_event_proofs_for_range_pipelined(
            store, pairs, _spec(), scan_threads=2, force_pipeline=True, **kw
        )
    merged, verdicts = range_mod.generate_and_verify_range_overlapped(
        store, pairs, _spec(), verify_chunk=lambda b: len(b.event_proofs), scan_threads=2,
        force_pipeline=True, **kw
    )
    assert len(verdicts) == N_CHUNKS
    return merged


def _run_ref(driver, store, pairs, metrics, **artifact):
    kw = dict(chunk_size=CHUNK, match_backend=ref_get_backend("cpu"), metrics=metrics,
              storage_specs=[RefSlotSpec(*s) for s in STORAGE], **artifact)
    if driver == "chunked":
        return ref_range.generate_event_proofs_for_range_chunked(store, pairs, RefSpec(SIG, TOPIC1, ACTOR), **kw)
    return ref_range.generate_event_proofs_for_range_pipelined(
        store, pairs, RefSpec(SIG, TOPIC1, ACTOR), scan_threads=2, force_pipeline=True, **kw
    )


def _artifact(kind, tmp_path):
    return {"checkpoint_dir": str(tmp_path / "ckpt")} if kind == "checkpoint" else {"job_dir": str(tmp_path / "job")}


@pytest.mark.parametrize("driver", ["chunked", "pipelined", "overlapped"])
@pytest.mark.parametrize("kind", ["checkpoint", "journal"])
def test_reference_artifacts_resume_in_the_port(tmp_path, worlds, kind, driver):
    store, pairs, ref_store, ref_pairs, reference = worlds
    art = _artifact(kind, tmp_path)
    # a pipelined run journals storage proofs apart from its chunk records
    # (in both packages), so its journal resumes the pipelined drivers only
    writer = "chunked" if kind == "checkpoint" or driver == "chunked" else "pipelined"
    first = _run_ref(writer, ref_store, ref_pairs, RefMetrics(), **art)
    assert first.to_json() == reference
    metrics = Metrics()
    assert _run_port(driver, store, pairs, metrics, **art).to_json() == reference
    assert metrics.counters["range_chunks_resumed"] == N_CHUNKS
    assert "range_chunks_generated" not in metrics.counters
    if kind == "journal":
        assert metrics.counters["jobs.chunks_replayed"] == N_CHUNKS


@pytest.mark.parametrize("driver", ["chunked", "pipelined"])
@pytest.mark.parametrize("kind", ["checkpoint", "journal"])
def test_port_artifacts_resume_in_the_reference(tmp_path, worlds, kind, driver):
    store, pairs, ref_store, ref_pairs, reference = worlds
    art = _artifact(kind, tmp_path)
    metrics = Metrics()
    assert _run_port(driver, store, pairs, metrics, **art).to_json() == reference
    assert metrics.counters["range_chunks_generated"] == N_CHUNKS
    ref_metrics = RefMetrics()
    assert _run_ref(driver, ref_store, ref_pairs, ref_metrics, **art).to_json() == reference
    assert ref_metrics.snapshot()["counters"]["range_chunks_resumed"] == N_CHUNKS
    if kind == "checkpoint":  # the reference's names: chunk_<sha256[:12]>_<NNNN>.json
        ref_repr = ref_range._request_spec_repr(
            RefSpec(SIG, TOPIC1, ACTOR), CHUNK, [RefSlotSpec(*s) for s in STORAGE]
        )
        expected = [
            f"chunk_{ref_range._chunk_checkpoint_digest(ref_repr, ref_pairs[k * CHUNK:(k + 1) * CHUNK])}_{k:04d}.json"
            for k in range(N_CHUNKS)
        ]
        assert sorted(os.listdir(tmp_path / "ckpt")) == sorted(expected)


@pytest.mark.parametrize("resumer", ["port", "reference"])
def test_torn_journal_tail_is_discarded_on_resume(tmp_path, worlds, resumer):
    """A journal whose last record is cut mid-frame resumes the committed
    prefix and regenerates the rest, in either package."""
    store, pairs, ref_store, ref_pairs, reference = worlds
    art = _artifact("journal", tmp_path)
    _run_port("pipelined", store, pairs, Metrics(), **art)
    path = tmp_path / "job" / JOBS_JOURNAL_NAME
    entries, _, _ = read_journal_entries(str(path))
    _, last_off, last_end = entries[-1]
    with open(path, "r+b") as fh:
        fh.truncate(last_off + (last_end - last_off) // 2)
    if resumer == "port":
        metrics = Metrics()
        assert _run_port("pipelined", store, pairs, metrics, **art).to_json() == reference
        counters = metrics.counters
    else:
        ref_metrics = RefMetrics()
        assert _run_ref("pipelined", ref_store, ref_pairs, ref_metrics, **art).to_json() == reference
        counters = ref_metrics.snapshot()["counters"]
    assert counters["jobs.chunks_replayed"] == N_CHUNKS - 1
    assert counters["range_chunks_generated"] == 1
    assert read_journal(str(path))[2] is False


def test_compacted_journal_replays_identically_in_both(tmp_path, worlds):
    store, pairs, ref_store, ref_pairs, reference = worlds
    art = _artifact("journal", tmp_path)
    _run_port("overlapped", store, pairs, Metrics(), **art)  # chunk records with verdicts
    spec_repr = range_mod._request_spec_repr(_spec(), CHUNK, [MappingSlotSpec(*s) for s in STORAGE])
    job = resume_or_create(art["job_dir"], job_manifest(spec_repr, pairs, CHUNK))
    try:
        before = {i: dict(rec) for i, rec in job.completed.items()}
        assert job.compact()
    finally:
        job.close()
    ref_job = ref_resume_or_create(art["job_dir"], ref_job_manifest(spec_repr, ref_pairs, CHUNK))
    try:
        assert ref_job.completed == before
    finally:
        ref_job.close()
    assert _run_ref("pipelined", ref_store, ref_pairs, RefMetrics(), **art).to_json() == reference


# --- SIGKILL at a journal record -------------------------------------------------------

_CHILD = """
import sys
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec

store, pairs, _ = build_range_world({n_pairs}, {receipts_per_pair}, {events_per_receipt}, {match_rate})
generate_event_proofs_for_range_pipelined(
    store, pairs, EventProofSpec({sig!r}, {topic1!r}, {actor}), chunk_size={chunk},
    match_backend=get_backend("gpu", device="cpu"), storage_specs=[MappingSlotSpec(*s) for s in {storage!r}],
    scan_threads=2, record_workers=2, force_pipeline=True, job_dir=sys.argv[1],
)
print("NOT KILLED")
"""


@pytest.mark.parametrize("crash_at,torn", [(1, None), (2, 64)], ids=["boundary", "torn"])
def test_sigkill_at_a_journal_record_resumes_identically(tmp_path, worlds, crash_at, torn):
    store, pairs, _, _, reference = worlds
    job_dir = tmp_path / "job"
    env = dict(os.environ, PYTHONPATH=str(ROOT), IPC_JOURNAL_CRASH_AT=str(crash_at))
    if torn is not None:
        env["IPC_JOURNAL_CRASH_TORN"] = str(torn)
    script = _CHILD.format(**WORLD, sig=SIG, topic1=TOPIC1, actor=ACTOR, chunk=CHUNK, storage=STORAGE)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(job_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == -9, (proc.returncode, proc.stdout, proc.stderr[-2000:])
    assert "NOT KILLED" not in proc.stdout
    records, _, tail = read_journal(str(job_dir / JOBS_JOURNAL_NAME))
    assert len(records) == (crash_at + 1 if torn is None else crash_at)
    assert tail == (torn is not None)
    metrics = Metrics()
    resumed = _run_port("pipelined", store, pairs, metrics, job_dir=str(job_dir))
    assert resumed.to_json() == reference
    assert metrics.counters["jobs.chunks_replayed"] == len(records)
    assert metrics.counters["range_chunks_generated"] == N_CHUNKS - len(records)
