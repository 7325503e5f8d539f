"""Inference serving (counterpart of ``mxnet_tpu/serve``): the
continuous-batching engine, its stdlib HTTP frontend, live weight
publishing and the multi-model registry, grammar-constrained and
self-speculative decoding, and the serving fleet: the multi-replica
router with tenants and prefix affinity, the autoscale controller, and
the cache-aware fleet's page migration and prefill / decode tiers."""
from .bucketing import bucket_for, bucket_ladder, next_pow2
from .cachefleet import (PrefillDecodePipeline, TieredFleetController,
                         install_preempt_rescue, migrate_prefix)
from .engine import (InferenceEngine, RequestHandle, ServeResult,
                     QueueFullError, EngineClosedError,
                     STATUS_OK, STATUS_TIMEOUT, STATUS_CANCELLED, STATUS_SHUTDOWN,
                     STATUS_ERROR)
from .fleet import AutoscalePolicy, FleetController, InProcessSpawner, SubprocessSpawner
from .grammar import TokenGrammar, clear_grammar_cache, compile_grammar, schema_regex
from .http import HTTPFrontend, serve_forever
from .paging import OutOfPages, PagePool, pages_for, prefix_key
from .registry import (ModelRegistry, QuotaExceededError, TenantPolicy, TenantScheduler,
                       WeightRefresher, latest_weight_version, publish_from_checkpoint,
                       publish_weights, read_weights, snapshot_params, weight_versions)
from .router import NoBackendError, Router, RouterFrontend
from .speculate import constrain_draft, draft_from_history

__all__ = ["InferenceEngine", "RequestHandle", "ServeResult",
           "QueueFullError", "EngineClosedError",
           "STATUS_OK", "STATUS_TIMEOUT", "STATUS_CANCELLED", "STATUS_SHUTDOWN",
           "STATUS_ERROR",
           "HTTPFrontend", "serve_forever",
           "PagePool", "OutOfPages", "pages_for", "prefix_key",
           "PrefillDecodePipeline", "TieredFleetController",
           "install_preempt_rescue", "migrate_prefix",
           "draft_from_history", "constrain_draft",
           "TokenGrammar", "compile_grammar", "schema_regex",
           "clear_grammar_cache",
           "Router", "RouterFrontend", "NoBackendError",
           "ModelRegistry", "WeightRefresher",
           "publish_weights", "publish_from_checkpoint", "read_weights",
           "snapshot_params", "latest_weight_version", "weight_versions",
           "TenantPolicy", "TenantScheduler", "QuotaExceededError",
           "AutoscalePolicy", "FleetController", "InProcessSpawner",
           "SubprocessSpawner",
           "bucket_for", "bucket_ladder", "next_pow2"]
