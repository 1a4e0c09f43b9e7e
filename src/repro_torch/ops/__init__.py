"""``repro_torch.ops`` (port of ``repro.ops``) — the ``batchweave`` operator
toolkit.

Programmatic API::

    from repro_torch.core import Namespace
    from repro_torch.ops import fsck, inspect_run

    report = fsck(Namespace(store, "runs/myjob"), repair=False)
    assert report.clean, report.summary()

CLI (filesystem-backed stores)::

    python -m repro_torch.ops --root /data/bw --namespace runs/myjob inspect
    python -m repro_torch.ops --root /data/bw -n runs/myjob fsck --repair
    python -m repro_torch.ops --root /data/bw -n runs/myjob trim --ranks 4

Host code only: no command allocates a tensor or takes a device. See
``docs/OPERATIONS.md`` for the full runbook.
"""
from repro_torch.ops.cli import build_parser, main
from repro_torch.ops.fsck import FsckIssue, FsckReport, fsck, list_streams
from repro_torch.ops.inspect import inspect_run

__all__ = ["FsckIssue", "FsckReport", "build_parser", "fsck", "inspect_run",
           "list_streams", "main"]
