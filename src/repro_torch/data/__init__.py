"""Data pipeline substrate (port of ``repro.data``): synthetic sources,
online packing and the disaggregated preprocessing pipeline. The two
baseline data planes the paper evaluates against (colocated 'Local',
Kafka-like MQ) wait (ROADMAP Queue 1, item 2c)."""
from repro_torch.core.errors import BatchTimeout
from repro_torch.data.packing import (GlobalBatchPacker, PackedBatch,
                                      assemble_grid, decode_slice)
from repro_torch.data.pipeline import PipelineConfig, PreprocessWorker
from repro_torch.data.sources import (PreprocessConfig, PreprocessResult,
                                      RawRecord, SyntheticSource,
                                      expansion_table, preprocess)

__all__ = [
    "BatchTimeout",
    "GlobalBatchPacker", "PackedBatch", "assemble_grid", "decode_slice",
    "PipelineConfig", "PreprocessWorker",
    "PreprocessConfig", "PreprocessResult", "RawRecord", "SyntheticSource",
    "expansion_table", "preprocess",
]
