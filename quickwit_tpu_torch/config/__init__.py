from .node_config import (load_node_config, load_index_config,
                          load_source_config)

__all__ = ["load_node_config", "load_index_config",
           "load_source_config"]
