"""Entry points: ``serve`` (batched prefill + greedy decode)."""
