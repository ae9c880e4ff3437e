"""Layers of the port: the int8 ABFT linear, the quantized EmbeddingBag
(DLRM tables and token embeddings), LayerNorm and the RWKV6 blocks."""
