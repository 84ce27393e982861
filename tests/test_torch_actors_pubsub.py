"""The port's actor runtime and event broker against the JAX package's.

`tests/test_actors.py`'s seven scenarios (priority lane, backpressure,
graceful quit, supervised restarts with a budget, accelerated time, the
frozen clock under a busy actor, a closed mailbox) and
`tests/test_common.py`'s two broker scenarios run in both packages
(`common/actors.py`, `common/pubsub.py`), plus a scripted run whose
observable trace (handler calls, mailbox order, restarts, states, virtual
ticks) must be equal between the two.
"""

import importlib
import queue
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def load(root):
    actors = importlib.import_module(f"{root}.common.actors")
    return SimpleNamespace(
        root=root, actors=actors, Actor=actors.Actor,
        Mailbox=actors.Mailbox, MailboxClosed=actors.MailboxClosed,
        Universe=actors.Universe,
        EventBroker=importlib.import_module(f"{root}.common").EventBroker,
        pubsub=importlib.import_module(f"{root}.common.pubsub"))


@pytest.fixture(params=PACKAGES)
def q(request):
    return load(request.param)


def collecting(q):
    class Collecting(q.Actor):
        name = "collector"

        def __init__(self):
            self.seen = []

        def on_message(self, message):
            self.seen.append(message)

    return Collecting()


def wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.005)
    return predicate()


# --- tests/test_actors.py, in both packages ------------------------------

def test_priority_lane_overtakes_data(q):
    mailbox = q.Mailbox("m", capacity=8)
    for i in range(4):
        mailbox.send(f"data-{i}")
    mailbox.send_priority("URGENT")
    lane, first = mailbox.recv(timeout=1)
    assert first == "URGENT" and lane == 0
    assert mailbox.recv(timeout=1)[1] == "data-0"


def test_backpressure_blocks_sender(q):
    mailbox = q.Mailbox("bp", capacity=2)
    mailbox.send("a")
    mailbox.send("b")
    with pytest.raises(queue.Full):
        mailbox.send("c", timeout=0.1)
    mailbox.send_priority("cmd")
    assert mailbox.recv(timeout=1)[1] == "cmd"


def test_actor_processes_and_quits(q):
    universe = q.Universe()
    actor = collecting(q)
    mailbox, handle = universe.spawn(actor)
    for i in range(10):
        mailbox.send(i)
    universe.quit()
    assert actor.seen == list(range(10))
    assert handle.state == "exited"


def test_supervisor_restarts_with_budget(q):
    universe = q.Universe(accelerated=True)
    crashes = []

    class Flaky(q.Actor):
        name = "flaky"

        def on_message(self, message):
            if message == "boom":
                crashes.append(message)
                raise RuntimeError("crash requested")

    mailbox, handle = universe.spawn(Flaky(), supervised=True,
                                     max_restarts=2)
    try:
        mailbox.send("boom")
        assert wait_for(lambda: handle.restarts >= 1)
        assert handle.restarts == 1 and handle.is_healthy()
        mailbox.send("boom")
        mailbox.send("boom")
        assert wait_for(lambda: handle.state == "failed")
        assert isinstance(handle.last_error, RuntimeError)
        assert len(crashes) == 3
    finally:
        universe.quit()


def test_accelerated_time_runs_timeouts_fast(q):
    universe = q.Universe(accelerated=True)
    ticks = []
    universe.schedule_periodic(600.0, lambda: ticks.append(universe.now()))
    t0 = time.monotonic()
    try:
        assert wait_for(lambda: len(ticks) >= 6)
        assert time.monotonic() - t0 < 5.0
        assert ticks[:6] == [600.0 * (i + 1) for i in range(6)]
    finally:
        universe.quit()


def test_accelerated_clock_waits_for_busy_actors(q):
    universe = q.Universe(accelerated=True)
    release = threading.Event()
    observed = []

    class Slow(q.Actor):
        name = "slow"

        def on_message(self, message):
            release.wait(2.0)
            observed.append(universe.now())

    mailbox, _ = universe.spawn(Slow())
    fired = []
    universe.schedule(100.0, lambda: fired.append(universe.now()))
    try:
        mailbox.send("work")
        time.sleep(0.2)
        assert not fired
        release.set()
        assert wait_for(lambda: bool(fired))
        assert observed == [0.0] and fired == [100.0]
    finally:
        release.set()
        universe.quit()


def test_closed_mailbox_raises(q):
    mailbox = q.Mailbox("closed")
    mailbox.close()
    with pytest.raises(q.MailboxClosed):
        mailbox.send("late")
    with pytest.raises(q.MailboxClosed):
        mailbox.try_send("late")
    with pytest.raises(q.MailboxClosed):
        mailbox.recv(timeout=0)


# --- tests/test_common.py's broker scenarios, in both packages -----------

def test_event_broker_typed_dispatch(q):
    broker = q.EventBroker()
    seen = []

    class EventA:
        pass

    class EventB:
        pass

    handle = broker.subscribe(EventA, seen.append)
    broker.publish(EventA())
    broker.publish(EventB())
    assert len(seen) == 1 and isinstance(seen[0], EventA)
    handle.cancel()
    broker.publish(EventA())
    assert len(seen) == 1


def test_event_broker_handler_exception_isolated(q):
    broker = q.EventBroker()
    seen = []

    class Ev:
        pass

    def bad(_):
        raise RuntimeError("boom")

    broker.subscribe(Ev, bad)
    broker.subscribe(Ev, seen.append)
    broker.publish(Ev())
    assert len(seen) == 1
    assert q.pubsub.EventSubscriptionHandle is type(
        broker.subscribe(Ev, seen.append))


# --- one scripted run, the same trace in both packages -------------------

def scripted_run(q):
    """Supervised and plain actors on one accelerated universe, with a
    broker fanning events out to them: the observable trace."""
    trace = []
    broker = q.EventBroker()
    universe = q.Universe(accelerated=True)

    class Recorder(q.Actor):
        def __init__(self, name, fail_on=()):
            self.name = name
            self.fail_on = set(fail_on)

        def on_start(self):
            trace.append(("start", self.name))

        def on_message(self, message):
            trace.append(("msg", self.name, message))
            if message in self.fail_on:
                self.fail_on.discard(message)
                raise ValueError(message)

        def on_exit(self):
            trace.append(("exit", self.name))

    a_mailbox, a = universe.spawn(Recorder("a", fail_on={"x2"}),
                                  supervised=True, max_restarts=5)
    b_mailbox, b = universe.spawn(Recorder("b"), capacity=4)
    broker.subscribe(str, a_mailbox.send)
    broker.subscribe(int, b_mailbox.send)
    ticks = []
    universe.schedule_periodic(30.0, lambda: ticks.append(universe.now()))
    try:
        for i in range(5):
            broker.publish(f"x{i}")
            broker.publish(i)
            assert wait_for(lambda: len(a.mailbox) == len(b.mailbox) == 0)
        assert wait_for(lambda: len(ticks) >= 4)
    finally:
        universe.quit()
    per_actor = {name: [t for t in trace if t[1] == name]
                 for name in ("a", "b")}
    return (per_actor, a.restarts, a.state, b.state,
            type(a.last_error).__name__, ticks[:4])


def test_scripted_actor_trace_matches_jax():
    want, got = (scripted_run(load(root)) for root in PACKAGES)
    assert got == want
    per_actor, restarts, a_state, b_state, error, ticks = got
    assert restarts == 1 and a_state == b_state == "exited"
    assert error == "ValueError" and ticks == [30.0, 60.0, 90.0, 120.0]
    assert per_actor["a"][:2] == [("start", "a"), ("msg", "a", "x0")]
