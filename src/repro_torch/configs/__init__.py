"""Architecture configurations of the port (copies of ``repro.configs``)."""
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs.dlrm import CONFIG as DLRM, EXTRAS, DlrmExtras
from repro_torch.configs.registry import get_arch, list_archs

__all__ = ["ArchConfig", "ShapeConfig", "DLRM", "EXTRAS", "DlrmExtras",
           "get_arch", "list_archs"]
