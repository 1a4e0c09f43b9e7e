"""Data pipeline substrate (port of ``repro.data``): synthetic sources,
online packing, the disaggregated preprocessing pipeline, and the two
baseline data planes the paper evaluates against (colocated 'Local',
Kafka-like MQ)."""
from repro_torch.core.errors import BatchTimeout
from repro_torch.data.colocated import (ColocatedConfig, ColocatedPipeline,
                                        StepTrace)
from repro_torch.data.mq import (BrokerConfig, KafkaSimBroker,
                                 KafkaTGBConsumer, KafkaTGBProducer,
                                 MessageTooLarge, RequestTimeout)
from repro_torch.data.packing import (GlobalBatchPacker, PackedBatch,
                                      assemble_grid, decode_slice)
from repro_torch.data.pipeline import PipelineConfig, PreprocessWorker
from repro_torch.data.sources import (PreprocessConfig, PreprocessResult,
                                      RawRecord, SyntheticSource,
                                      expansion_table, preprocess)

__all__ = [
    "BatchTimeout",
    "ColocatedConfig", "ColocatedPipeline", "StepTrace",
    "BrokerConfig", "KafkaSimBroker", "KafkaTGBConsumer", "KafkaTGBProducer",
    "MessageTooLarge", "RequestTimeout",
    "GlobalBatchPacker", "PackedBatch", "assemble_grid", "decode_slice",
    "PipelineConfig", "PreprocessWorker",
    "PreprocessConfig", "PreprocessResult", "RawRecord", "SyntheticSource",
    "expansion_table", "preprocess",
]
