"""Token packing (port of ``repro.data.packing``): ``GlobalBatchPacker``,
``assemble_grid``. The reference's sources, preprocessing pipeline and the
mq/colocated baselines wait (ROADMAP Queue 1, item 2c)."""
from repro_torch.data.packing import (GlobalBatchPacker, PackedBatch,
                                      assemble_grid, decode_slice)

__all__ = ["GlobalBatchPacker", "PackedBatch", "assemble_grid",
           "decode_slice"]
