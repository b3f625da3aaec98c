"""Entry points: ``serve`` (batched prefill + greedy decode) and ``train``
(CHB training of an LM, the scan strategy)."""
