"""Serving on the port: decode (paged KV cache, decoder, DecodeEngine),
batched inference (ServingEngine over AnalysisPredictor), the wire
(ServingServer and ServingClient over the port's RPC transport, frames
packed by ``codec``), and the fleet's control plane (ServingFleet and
AutoScaler, RolloutController and its gate, FleetMonitor)."""

from .client import ServingClient, read_endpoints_doc, read_endpoints_file
from .decode_model import (Decoder, DecoderConfig, from_jax_params,
                           init_decoder_params, load_decoder, save_decoder)
from .engine import (DecodeEngine, InferReply, ServingEngine, parse_buckets,
                     parse_tier_weights, tier_weight)
from .fleet import AutoScaler, ServingFleet
from .fleetmon import FleetMonitor
from .kv_cache import (BlockAllocator, KVCacheConfig, PagedKVCache,
                       PrefixCache, block_bytes, plan_num_blocks)
from .rollout import (RolloutController, evaluate_gate, merge_stats,
                      stats_from_snapshot)
from .server import ServingServer

__all__ = ["Decoder", "DecoderConfig", "from_jax_params",
           "init_decoder_params", "load_decoder", "save_decoder",
           "DecodeEngine", "InferReply", "ServingEngine",
           "parse_tier_weights", "tier_weight",
           "parse_buckets", "BlockAllocator", "KVCacheConfig",
           "PagedKVCache", "PrefixCache", "block_bytes", "plan_num_blocks",
           "ServingServer", "ServingClient", "read_endpoints_file",
           "read_endpoints_doc", "ServingFleet", "AutoScaler",
           "RolloutController", "FleetMonitor", "evaluate_gate",
           "stats_from_snapshot", "merge_stats"]
