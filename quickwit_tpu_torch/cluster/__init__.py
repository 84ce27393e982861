from .membership import Cluster, ClusterChange, ClusterMember

__all__ = ["Cluster", "ClusterChange", "ClusterMember"]
