"""Decode serving on the port: paged KV cache, decoder, engine."""

from .decode_model import (Decoder, DecoderConfig, from_jax_params,
                           init_decoder_params, load_decoder, save_decoder)
from .engine import DecodeEngine, InferReply, parse_buckets
from .kv_cache import (BlockAllocator, KVCacheConfig, PagedKVCache,
                       PrefixCache, block_bytes, plan_num_blocks)

__all__ = ["Decoder", "DecoderConfig", "from_jax_params",
           "init_decoder_params", "load_decoder", "save_decoder",
           "DecodeEngine", "InferReply",
           "parse_buckets", "BlockAllocator", "KVCacheConfig",
           "PagedKVCache", "PrefixCache", "block_bytes", "plan_num_blocks"]
