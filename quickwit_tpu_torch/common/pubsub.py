"""In-process typed pub/sub event broker.

Role of the reference's `quickwit-common/src/pubsub.rs`: decoupled event
dissemination between subsystems (e.g. shard-position updates, split report
events). Subscriptions are keyed by event type; handlers run inline or on a
background thread.

Carried over whole from the JAX package's `common/pubsub.py`.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Any, Callable, Type, TypeVar

logger = logging.getLogger(__name__)

E = TypeVar("E")


class EventSubscriptionHandle:
    def __init__(self, broker: "EventBroker", event_type: type, key: int):
        self._broker = broker
        self._event_type = event_type
        self._key = key

    def cancel(self) -> None:
        self._broker._unsubscribe(self._event_type, self._key)


class EventBroker:
    """Typed pub/sub: subscribe by event class, publish instances."""

    def __init__(self) -> None:
        # qwlint: disable-next-line=QW008 - leaf lock on the subscriber map; no
        # instrumented ops inside
        self._lock = threading.Lock()
        self._subscribers: dict[type, dict[int, Callable[[Any], None]]] = defaultdict(dict)
        self._next_key = 0

    def subscribe(self, event_type: Type[E], handler: Callable[[E], None]) -> EventSubscriptionHandle:
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._subscribers[event_type][key] = handler
        return EventSubscriptionHandle(self, event_type, key)

    def _unsubscribe(self, event_type: type, key: int) -> None:
        with self._lock:
            self._subscribers.get(event_type, {}).pop(key, None)

    def publish(self, event: Any) -> None:
        with self._lock:
            handlers = list(self._subscribers.get(type(event), {}).values())
        for handler in handlers:
            try:
                handler(event)
            except Exception:  # noqa: BLE001 - subscriber bugs must not kill publishers
                logger.exception("event handler failed for %r", type(event).__name__)
