"""Models of the port: the paper's DLRM (:mod:`.dlrm`) and the converter
from the JAX package's weights (:mod:`.convert`)."""
