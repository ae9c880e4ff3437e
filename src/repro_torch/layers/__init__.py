"""Layers of the port: the int8 ABFT linear and the quantized EmbeddingBag."""
