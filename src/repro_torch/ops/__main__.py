"""``python -m repro_torch.ops`` — the ``batchweave`` ops CLI (port of
``repro.ops.__main__``)."""
import sys

from repro_torch.ops.cli import main

if __name__ == "__main__":
    sys.exit(main())
