"""Foundation utilities carried over from the JAX package."""
from .uri import Uri
from .pubsub import EventBroker
from .rendezvous import sort_by_rendezvous_hash

__all__ = ["Uri", "EventBroker", "sort_by_rendezvous_hash"]
