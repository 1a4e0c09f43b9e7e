"""``repro_torch.run`` (port of ``repro.run``) — checkpoint-aligned run
lifecycle (RunManifest + TrainSession).

The piece that turns "a data plane plus a training loop" into one
recoverable training system: a versioned RunManifest atomically binds the
model checkpoint pointer to the data-plane cursors in a single conditional
object-store commit, and ``TrainSession`` is the facade training loops use
to save/resume through it — including elastic (factor DP resize) restores.
RunManifest entries and model checkpoints are byte-compatible with the
reference's, so a run checkpointed by either package resumes in the other.
"""
from repro_torch.run.manifest import (RUN_SCHEMA, RUNMANIFEST_DIR,
                                      RunManifest, RunManifestError,
                                      RunManifestStore)
from repro_torch.run.session import TrainSession

__all__ = [
    "RUN_SCHEMA", "RUNMANIFEST_DIR", "RunManifest", "RunManifestError",
    "RunManifestStore", "TrainSession",
]
