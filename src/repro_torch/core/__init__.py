"""BatchWeave core (port of ``repro.core``): the tgb data plane's clients.

Only the modules the tgb path runs are copied, each verbatim but for its
imports: object stores, TGBs, manifests and the commit protocol, DAC, the
producer and consumer clients, lifecycle (watermarks, reclamation, the trim
marker), fault injection and the resilience layer (``ResilientStore``:
backoff + retry budgets, AIMD throttle governor, hedged reads, circuit
breaker) and the compactor of sharded manifest chains. ``_msgpack`` stands
in for the msgpack package (byte-identical output).
"""
from repro_torch.core.clock import Clock, SystemClock, VirtualClock
from repro_torch.core.compactor import CompactStats, Compactor
from repro_torch.core.commit import (CommitProtocol, CommitResult,
                                     ShardStats, ShardedCommitProtocol)
from repro_torch.core.consumer import (Consumer, ConsumerStats, MeshPosition,
                                       convert_logical_step,
                                       floor_to_data_step, remap_step)
from repro_torch.core.dac import (AIMDPolicy, CommitPolicy, DACConfig,
                                  DACPolicy, FixedCountPolicy, IncrPolicy,
                                  NaivePolicy, ShardChooser, make_policy)
from repro_torch.core.errors import (BatchTimeout, CircuitOpenError,
                                     RetryBudgetExhausted, ThrottledError,
                                     TransientStoreError, backoff_delays,
                                     retry_transient)
from repro_torch.core.faults import (BrownoutPhase, FaultPolicy, FaultStats,
                                     FaultyObjectStore)
from repro_torch.core.lifecycle import (Reclaimer, Watermark,
                                        global_watermark, read_trim_marker,
                                        read_watermarks, write_watermark)
from repro_torch.core.manifest import (DatasetView, ManifestStore,
                                       ProducerState, ShardedManifestStore,
                                       StepUnavailable, open_manifest_store,
                                       read_shard_config, write_shard_config)
from repro_torch.core.objectstore import (ConditionalPutFailed,
                                          FaultInjector, FileObjectStore,
                                          InjectedCrash, IOPool,
                                          LatencyModel, MemoryObjectStore,
                                          Namespace, NoSuchKey, ObjectStore,
                                          ZERO_LATENCY)
from repro_torch.core.producer import (Producer, ProducerStats,
                                       run_producer_loop)
from repro_torch.core.resilience import (AIMDGovernor, CircuitBreaker,
                                         HedgePolicy, ResilienceConfig,
                                         ResilientStore, RetryBudget,
                                         StoreResilienceStats,
                                         shared_governor, wrap_store)
from repro_torch.core.stats import LatencyWindow, percentile, percentiles
from repro_torch.core.tgb import (TGBBuilder, TGBDescriptor, TGBFooter,
                                  TGBReader)

__all__ = [
    "BatchTimeout", "TransientStoreError", "ThrottledError",
    "CircuitOpenError", "RetryBudgetExhausted", "backoff_delays",
    "retry_transient",
    "Clock", "SystemClock", "VirtualClock",
    "BrownoutPhase", "FaultPolicy", "FaultStats", "FaultyObjectStore",
    "CompactStats", "Compactor",
    "CommitProtocol", "CommitResult", "ShardStats", "ShardedCommitProtocol",
    "ShardChooser",
    "Consumer", "ConsumerStats", "MeshPosition", "convert_logical_step",
    "floor_to_data_step", "remap_step",
    "AIMDPolicy", "CommitPolicy", "DACConfig", "DACPolicy",
    "FixedCountPolicy", "IncrPolicy", "NaivePolicy", "make_policy",
    "Reclaimer", "Watermark", "global_watermark", "read_trim_marker",
    "read_watermarks", "write_watermark",
    "DatasetView", "ManifestStore", "ProducerState", "ShardedManifestStore",
    "StepUnavailable", "open_manifest_store", "read_shard_config",
    "write_shard_config",
    "ConditionalPutFailed", "FaultInjector", "FileObjectStore",
    "InjectedCrash", "IOPool", "LatencyModel",
    "MemoryObjectStore", "Namespace", "NoSuchKey", "ObjectStore",
    "ZERO_LATENCY",
    "LatencyWindow", "percentile", "percentiles",
    "Producer", "ProducerStats", "run_producer_loop",
    "AIMDGovernor", "CircuitBreaker", "HedgePolicy", "ResilienceConfig",
    "ResilientStore", "RetryBudget", "StoreResilienceStats",
    "shared_governor", "wrap_store",
    "TGBBuilder", "TGBDescriptor", "TGBFooter", "TGBReader",
]
