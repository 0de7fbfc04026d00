"""Check engines: the exact host ``oracle`` and the batched CUDA engine
(``device``), plus the snapshot projection both read."""
