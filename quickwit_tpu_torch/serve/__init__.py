from .node import Node, NodeConfig
from .rest import RestServer

__all__ = ["Node", "NodeConfig", "RestServer"]
