"""The LM side of the port: config, layers, KV caches, the attention stack
and the public model API (prefill, decode step, forward)."""
