"""Data pipelines (synthetic LM/byte/image streams, prefetch, host
sharding)."""

from .pipeline import (ByteCorpus, Prefetcher, SyntheticImages, SyntheticLM,
                       shard_for_host)

__all__ = ["SyntheticLM", "ByteCorpus", "SyntheticImages", "Prefetcher",
           "shard_for_host"]
