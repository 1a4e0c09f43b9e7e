"""``repro_torch.ops`` (port of ``repro.ops``) — the operator toolkit's
integrity checker and run inspector.

Programmatic API::

    from repro_torch.core import Namespace
    from repro_torch.ops import fsck, inspect_run

    report = fsck(Namespace(store, "runs/myjob"), repair=False)
    assert report.clean, report.summary()

The reference's CLI (``ops/cli.py``) and its ``ops/obs.py`` are not ported
yet: ROADMAP Queue 1, item 9.
"""
from repro_torch.ops.fsck import FsckIssue, FsckReport, fsck, list_streams
from repro_torch.ops.inspect import inspect_run

__all__ = ["FsckIssue", "FsckReport", "fsck", "inspect_run", "list_streams"]
