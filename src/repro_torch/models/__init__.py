"""The LM side of the port: config, layers, KV caches, the Mamba2 (SSD) and
RWKV6 blocks, the attention, Mamba2 / zamba2-hybrid and RWKV6 stacks, the
public model API (prefill, decode step, forward) and the decode step as a
CUDA graph (``decode_graph``)."""
