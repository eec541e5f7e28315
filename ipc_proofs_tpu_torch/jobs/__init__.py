"""Crash-safe resumable range jobs: chunk-granular write-ahead journaling.

The counterpart of ``ipc_proofs_tpu.jobs``. The journal is the durability
primitive (`journal.py`: fsync'd, length-prefixed, CRC-checksummed
append-only records with torn-tail recovery); `job.py` builds the range-job
layer on top (manifest identity, completed-chunk replay,
`resume_or_create`). Frames, manifests and records are byte for byte the
reference's.
"""

from ipc_proofs_tpu_torch.jobs.job import (
    JOBS_JOURNAL_NAME,
    JOBS_MANIFEST_NAME,
    RangeJob,
    job_manifest,
    resume_or_create,
)
from ipc_proofs_tpu_torch.jobs.journal import (
    JOURNAL_MAGIC,
    JournalError,
    JournalWriter,
    read_journal,
)

__all__ = [
    "JOURNAL_MAGIC",
    "JournalError",
    "JournalWriter",
    "read_journal",
    "JOBS_JOURNAL_NAME",
    "JOBS_MANIFEST_NAME",
    "RangeJob",
    "job_manifest",
    "resume_or_create",
]
