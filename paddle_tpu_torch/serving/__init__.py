"""Serving on the port: decode (paged KV cache in f32 or int8, decoder
and its draft, DecodeEngine with speculative decode),
batched inference (ServingEngine over AnalysisPredictor), the wire
(ServingServer and ServingClient over the port's RPC transport, frames
packed by ``codec``), the fleet's control plane (ServingFleet and
AutoScaler, RolloutController and its gate, FleetMonitor), and KV state
between replicas: the disaggregated prefill and decode roles
(KVBlockSender, AdoptTracker) and live session migration
(SessionMigrator, ResumeBuffer, tail_digest)."""

from .client import ServingClient, read_endpoints_doc, read_endpoints_file
from .disagg import AdoptTracker, KVBlockSender
from .decode_model import (Decoder, DecoderConfig, from_jax_params,
                           has_draft, init_decoder_params, is_decoder_dir,
                           load_decoder, load_draft, save_decoder,
                           truncate_decoder)
from .engine import (DecodeEngine, InferReply, ServingEngine, parse_buckets,
                     parse_tier_weights, tier_weight)
from .fleet import AutoScaler, ServingFleet
from .fleetmon import FleetMonitor
from .kv_cache import (BlockAllocator, KVCacheConfig, PagedKVCache,
                       PrefixCache, block_bytes, dequantize_kv,
                       plan_num_blocks, quantize_kv)
from .migrate import ResumeBuffer, SessionMigrator, tail_digest
from .rollout import (RolloutController, evaluate_gate, merge_stats,
                      stats_from_snapshot)
from .server import ServingServer

__all__ = ["Decoder", "DecoderConfig", "from_jax_params",
           "init_decoder_params", "load_decoder", "save_decoder",
           "is_decoder_dir", "has_draft", "load_draft", "truncate_decoder",
           "DecodeEngine", "InferReply", "ServingEngine",
           "parse_tier_weights", "tier_weight",
           "parse_buckets", "BlockAllocator", "KVCacheConfig",
           "PagedKVCache", "PrefixCache", "block_bytes", "plan_num_blocks",
           "quantize_kv", "dequantize_kv",
           "ServingServer", "ServingClient", "read_endpoints_file",
           "read_endpoints_doc", "ServingFleet", "AutoScaler",
           "RolloutController", "FleetMonitor", "evaluate_gate",
           "stats_from_snapshot", "merge_stats", "KVBlockSender",
           "AdoptTracker", "SessionMigrator", "ResumeBuffer", "tail_digest"]
