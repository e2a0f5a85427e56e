"""Serving-side host machinery: deadline micro-batching in front of the
int8 engine's batch buckets."""

from dfq_tpu_torch.serve.microbatch import MicroBatcher, MicroBatchStats

__all__ = ["MicroBatcher", "MicroBatchStats"]
