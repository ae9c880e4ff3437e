"""Models of the port: the paper's DLRM (:mod:`.dlrm`), RWKV6
(:mod:`.rwkv`, served through the :mod:`.base` facade) and the converter
from the JAX package's weights (:mod:`.convert`)."""
