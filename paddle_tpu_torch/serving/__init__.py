"""Serving on the port: decode (paged KV cache, decoder, DecodeEngine)
and batched inference (ServingEngine over AnalysisPredictor)."""

from .decode_model import (Decoder, DecoderConfig, from_jax_params,
                           init_decoder_params, load_decoder, save_decoder)
from .engine import (DecodeEngine, InferReply, ServingEngine, parse_buckets,
                     parse_tier_weights, tier_weight)
from .kv_cache import (BlockAllocator, KVCacheConfig, PagedKVCache,
                       PrefixCache, block_bytes, plan_num_blocks)

__all__ = ["Decoder", "DecoderConfig", "from_jax_params",
           "init_decoder_params", "load_decoder", "save_decoder",
           "DecodeEngine", "InferReply", "ServingEngine",
           "parse_tier_weights", "tier_weight",
           "parse_buckets", "BlockAllocator", "KVCacheConfig",
           "PagedKVCache", "PrefixCache", "block_bytes", "plan_num_blocks"]
