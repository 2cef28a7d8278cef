"""Domain-decomposed solves on torch.distributed, one process per block
(port of ``mgpoisson/shard``; the explicit partition only)."""
