"""Actor runtime: mailboxes, supervision, simulated time.

Role of the reference's `quickwit-actors` crate (`src/actor.rs:101`,
`src/mailbox.rs:46`, `src/supervisor.rs:44`, `src/scheduler.rs:66-130`):
the host-side services (indexing pipelines, janitor, control plane
loops) are single-threaded actors with

- **priority mailboxes**: bounded queues with a high-priority lane
  (supervision/command messages overtake data), where `send` BLOCKS when
  the queue is full — backpressure propagates upstream instead of
  buffering unboundedly;
- **supervision**: a crashed actor (handler exception) is restarted by
  its supervisor with exponential backoff, up to a restart budget, then
  marked failed (the reference's supervision tree);
- **simulated time**: `universe.sleep`/`schedule` run on a virtual
  clock; in accelerated mode (tests) the clock JUMPS to the next
  scheduled deadline whenever every actor is idle, so timeout/retry
  behavior runs in milliseconds (`scheduler.rs:72-130` accelerate_time).

This runtime is deliberately host-side only: the device compute path is
torch on the card — actors coordinate IO, pipelines, and periodic work
around it.

Carried over whole from the JAX package's `common/actors.py`.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .clock import get_clock

logger = logging.getLogger(__name__)

_HIGH = 0
_LOW = 1


class MailboxClosed(RuntimeError):
    pass


class Mailbox:
    """Bounded two-lane queue: high-priority messages overtake low ones
    (reference: `channel_with_priority.rs:118`). `send` blocks when the
    low lane is full — that IS the backpressure mechanism."""

    def __init__(self, name: str, capacity: int = 64,
                 on_activity: Optional[Callable[[int], None]] = None):
        self.name = name
        self._low: "queue.Queue[Any]" = queue.Queue(maxsize=capacity)
        self._high: "queue.Queue[Any]" = queue.Queue()  # never blocks
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        self._closed = threading.Event()
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        self._not_empty = threading.Condition()
        # universe hook counting in-flight messages (idle detection for
        # accelerated time)
        self._on_activity = on_activity or (lambda delta: None)

    def send(self, message: Any, timeout: Optional[float] = None) -> None:
        if self._closed.is_set():
            raise MailboxClosed(self.name)
        self._on_activity(+1)
        try:
            self._low.put(message, timeout=timeout)
        except queue.Full:
            self._on_activity(-1)
            raise
        with self._not_empty:
            self._not_empty.notify()

    def try_send(self, message: Any) -> bool:
        if self._closed.is_set():
            raise MailboxClosed(self.name)
        try:
            self._low.put_nowait(message)
        except queue.Full:
            return False
        self._on_activity(+1)
        with self._not_empty:
            self._not_empty.notify()
        return True

    def send_priority(self, message: Any) -> None:
        """High lane: unbounded, overtakes data messages (supervision and
        commands must reach a backpressured actor)."""
        if self._closed.is_set():
            raise MailboxClosed(self.name)
        self._on_activity(+1)
        self._high.put(message)
        with self._not_empty:
            self._not_empty.notify()

    def recv(self, timeout: Optional[float] = None) -> tuple[int, Any]:
        """(lane, message); raises queue.Empty on timeout, MailboxClosed
        when closed and drained. The queue checks happen while HOLDING the
        condition, so a send's notify cannot slip between a failed check
        and the wait (no lost wakeups, no polling — idle actors sleep the
        full timeout)."""
        deadline = (get_clock().monotonic() + timeout
                    if timeout is not None else None)
        with self._not_empty:
            while True:
                try:
                    return _HIGH, self._high.get_nowait()
                except queue.Empty:
                    pass
                try:
                    return _LOW, self._low.get_nowait()
                except queue.Empty:
                    pass
                if self._closed.is_set():
                    raise MailboxClosed(self.name)
                remaining = (None if deadline is None
                             else deadline - get_clock().monotonic())
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._not_empty.wait(remaining)

    def close(self) -> None:
        self._closed.set()
        with self._not_empty:
            self._not_empty.notify_all()

    def __len__(self) -> int:
        return self._high.qsize() + self._low.qsize()


class Actor:
    """Override `on_message`; optionally `on_start` / `on_exit`.
    `self.universe` / `self.mailbox` are set at spawn."""

    name = "actor"

    def on_start(self) -> None:  # noqa: B027
        pass

    def on_message(self, message: Any) -> None:
        raise NotImplementedError

    def on_exit(self) -> None:  # noqa: B027
        pass


@dataclass
class ActorHandle:
    name: str
    mailbox: Mailbox
    thread: threading.Thread
    state: str = "running"     # running | exited | failed
    restarts: int = 0
    last_error: Optional[BaseException] = None
    _exited: threading.Event = field(default_factory=threading.Event)

    def join(self, timeout: Optional[float] = None) -> None:
        self._exited.wait(timeout)

    def is_healthy(self) -> bool:
        return self.state == "running"


class _Quit:
    pass


class Universe:
    """Actor spawner + virtual clock (reference `Universe`,
    `universe.rs:31`). `accelerated=True` gives tests simulated time:
    whenever every actor is idle and no message is in flight, `now()`
    jumps to the next scheduled deadline."""

    def __init__(self, accelerated: bool = False):
        self.accelerated = accelerated
        self._handles: list[ActorHandle] = []
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        self._lock = threading.Lock()
        self._inflight = 0
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        self._idle = threading.Condition()
        # virtual clock (only consulted in accelerated mode)
        self._virtual_now = 0.0
        self._timers: list[tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = itertools.count()
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        self._stop = threading.Event()
        # qwlint: disable-next-line=QW003 - the universe clock is
        # process-lifetime infrastructure with no query context to carry
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        self._clock_thread = threading.Thread(
            target=self._clock_loop, name="universe-clock", daemon=True)
        self._clock_thread.start()

    # --- time ---------------------------------------------------------
    def now(self) -> float:
        if self.accelerated:
            with self._idle:
                return self._virtual_now
        return get_clock().monotonic()

    def schedule(self, delay: float, callback: Callable[[], None]) -> None:
        """Run `callback` after `delay` (virtual seconds when
        accelerated) — the reference SchedulerClient's schedule_event."""
        with self._idle:
            heapq.heappush(self._timers,
                           (self.now_locked() + delay,
                            next(self._timer_seq), callback))
            self._idle.notify_all()

    def now_locked(self) -> float:
        return (self._virtual_now if self.accelerated
                else get_clock().monotonic())

    def schedule_periodic(self, interval: float,
                          callback: Callable[[], None]) -> None:
        def tick() -> None:
            if self._stop.is_set():
                return
            try:
                callback()
            except Exception:  # noqa: BLE001 - periodic must survive
                logger.exception("periodic task failed")
            self.schedule(interval, tick)

        self.schedule(interval, tick)

    def _clock_loop(self) -> None:
        while not self._stop.is_set():
            with self._idle:
                if not self._timers:
                    # schedule()/quit() notify under this condition, so an
                    # unbounded wait cannot lose a wakeup
                    self._idle.wait(1.0)
                    continue
                deadline, _, callback = self._timers[0]
                now = self.now_locked()
                if now >= deadline:
                    heapq.heappop(self._timers)
                elif self.accelerated and self._inflight == 0 and \
                        all(len(h.mailbox) == 0 for h in self._handles):
                    # system idle: jump the virtual clock (the whole point
                    # of simulated time — timeouts run in microseconds)
                    self._virtual_now = deadline
                    heapq.heappop(self._timers)
                else:
                    # schedule()/quit() notify this condition, so real-time
                    # mode can sleep the full remaining interval; the 1ms
                    # poll exists only for accelerated idle detection
                    self._idle.wait(0.001 if self.accelerated else
                                    min(deadline - now, 5.0))
                    continue
            try:
                callback()
            except Exception:  # noqa: BLE001
                logger.exception("scheduled callback failed")

    # --- activity accounting (idle detection) -------------------------
    def _on_activity(self, delta: int) -> None:
        with self._idle:
            self._inflight += delta
            if self._inflight == 0:
                self._idle.notify_all()

    # --- spawning -----------------------------------------------------
    def spawn(self, actor: Actor, capacity: int = 64,
              supervised: bool = False, max_restarts: int = 3
              ) -> tuple[Mailbox, ActorHandle]:
        mailbox = Mailbox(actor.name, capacity,
                          on_activity=self._on_activity)
        handle = ActorHandle(actor.name, mailbox, thread=None)  # type: ignore[arg-type]

        def run() -> None:
            backoff = 0.1
            current = actor
            while True:
                current.universe = self
                current.mailbox = mailbox
                try:
                    current.on_start()
                    while True:
                        try:
                            _, message = mailbox.recv(timeout=0.5)
                        except queue.Empty:
                            continue
                        except MailboxClosed:
                            break
                        try:
                            if isinstance(message, _Quit):
                                break
                            current.on_message(message)
                        finally:
                            self._on_activity(-1)
                    current.on_exit()
                    handle.state = "exited"
                    break
                except BaseException as exc:  # noqa: BLE001 - supervise
                    handle.last_error = exc
                    if not supervised or handle.restarts >= max_restarts:
                        handle.state = "failed"
                        logger.error("actor %s failed permanently: %s",
                                     actor.name, exc)
                        # drain + close: queued messages must not count as
                        # in-flight forever (they would freeze the
                        # accelerated clock), and draining frees capacity
                        # so a blocked sender unblocks instead of hanging
                        mailbox.close()
                        while True:
                            try:
                                mailbox.recv(timeout=0)
                            except (queue.Empty, MailboxClosed):
                                break
                            self._on_activity(-1)
                        break
                    handle.restarts += 1
                    logger.warning("actor %s crashed (%s); restart #%d",
                                   actor.name, exc, handle.restarts)
                    # accelerated mode: messages queued behind the crash
                    # keep the system non-idle, so a virtual-clock backoff
                    # would deadlock — restart (near-)immediately instead
                    get_clock().sleep(0.001 if self.accelerated else backoff)
                    backoff = min(backoff * 2, 5.0)
            handle._exited.set()

        # qwlint: disable-next-line=QW003 - actor mailbox loops outlive
        # any query; messages carry their own metadata instead
        # qwlint: disable-next-line=QW008 - actor mailboxes rendezvous through
        # queue.Queue, which the qwrace scheduler cannot see; gating these
        # primitives would stall the gated token on invisible queue waits
        thread = threading.Thread(target=run, name=f"actor-{actor.name}",
                                  daemon=True)
        handle.thread = thread
        with self._lock:
            self._handles.append(handle)
        thread.start()
        return mailbox, handle

    # --- lifecycle ----------------------------------------------------
    def quit(self, timeout: float = 5.0) -> None:
        """Graceful: the quit marker rides the LOW lane, so pending data
        messages drain first (the reference's ExitStatus::Success); a
        backpressured mailbox gets the priority lane instead (kill)."""
        for handle in self._handles:
            try:
                if not handle.mailbox.try_send(_Quit()):
                    handle.mailbox.send_priority(_Quit())
            except MailboxClosed:
                pass
        for handle in self._handles:
            handle.join(timeout)
            handle.mailbox.close()
        self._stop.set()
        with self._idle:
            self._idle.notify_all()

    def handles(self) -> list[ActorHandle]:
        with self._lock:
            return list(self._handles)
