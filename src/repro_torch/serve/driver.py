"""Self-driving tick loop for the sparse serving engine.

The port of the JAX package's ``repro/serve/driver.py``, unchanged in
behaviour. The engine is caller-ticked: correct, deterministic, and
great for tests, but a production client should not own a scheduling
loop. A :class:`ServeDriver` wraps one
:class:`~repro_torch.serve.sparse.SparseServeEngine` in a daemon thread
that calls ``engine.step()`` continuously, so the client-side protocol
collapses to::

    with ServeDriver(engine):
        t = engine.submit("social", "pagerank", payload=..., tenant="ana")
        t.wait(timeout=5.0)        # blocks until DONE/EXPIRED/FAILED

Design points, in the order they matter:

* **The engine stays the unit of correctness.** The driver adds *no*
  scheduling logic — every fairness, deadline, and recovery decision
  lives in ``step()``, which takes the engine lock for the whole tick
  body. The driver thread and any number of submitting threads
  serialize through that lock, so the snapshot/restore recovery of the
  fault runtime runs under the driver unchanged (the guarded tick body
  never observes a half-submitted ticket). The deterministic fake-clock
  path keeps working too: tests that want exact tick counts simply
  don't start a driver.
* **The driver thread launches the kernels.** Each tick's SpMMs run in
  this thread, on its current CUDA stream — the default stream, since
  the driver sets none. The kernels' launch counters are plain
  integers; they stay exact because the engine lock serializes every
  tick.
* **Idle backoff, event wakeup.** When a tick reports no lane stepped
  and nothing is pending, the driver parks on the engine's work event
  with exponentially growing sleeps (``idle_backoff_min`` →
  ``idle_backoff_max``); ``submit()`` sets the event, so the first
  request after an idle spell is picked up immediately instead of on
  the next poll. A busy driver re-ticks back-to-back (or at a fixed
  ``interval`` cadence when configured — useful to cap CPU on a shared
  box or to make room for submitter threads on small machines).
* **``drain()`` vs ``stop()``.** ``drain()`` waits until every admitted
  request is terminal *while the loop keeps ticking* — it is the
  graceful-shutdown first half, and it requires a running driver (a
  stopped loop would make the wait a hang; that asymmetry is enforced
  with a ``RuntimeError``). ``stop()`` halts the loop after the current
  tick completes, mid-queue or not — tickets still queued simply stay
  QUEUED. Graceful shutdown is therefore ``drain(); stop()``, which is
  exactly what the context-manager exit does.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.serve.sparse import SparseServeEngine

__all__ = ["ServeDriver"]


class ServeDriver:
    """Owns the tick cadence of one engine on a daemon thread.

    ``interval`` throttles *busy* ticks (0.0 = tick back-to-back);
    ``idle_backoff_min``/``idle_backoff_max`` bound the exponential
    sleep between *idle* polls. ``drain_poll`` is the pending-count
    poll period used by :meth:`drain`.

    Restartable: ``start()`` after ``stop()`` spins up a fresh thread
    over the same engine. Also a context manager — ``__exit__`` drains
    (best-effort) then stops, so the ``with`` block above never leaks a
    thread or abandons an in-flight solve.
    """

    def __init__(
        self,
        engine: SparseServeEngine,
        *,
        interval: float = 0.0,
        idle_backoff_min: float = 1e-4,
        idle_backoff_max: float = 0.05,
        drain_poll: float = 1e-3,
    ):
        if interval < 0.0:
            raise ValueError(f"interval must be >= 0, got {interval}")
        if not 0.0 < idle_backoff_min <= idle_backoff_max:
            raise ValueError(
                f"need 0 < idle_backoff_min <= idle_backoff_max, got "
                f"{idle_backoff_min} / {idle_backoff_max}"
            )
        self.engine = engine
        self.interval = float(interval)
        self.idle_backoff_min = float(idle_backoff_min)
        self.idle_backoff_max = float(idle_backoff_max)
        self.drain_poll = float(drain_poll)
        self.ticks = 0  # loop iterations that called step() (driver-side)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ServeDriver":
        """Spin up the tick thread; idempotent-hostile on purpose — two
        live loops over one engine would double-tick, so a second
        ``start()`` while running raises."""
        if self.running:
            raise RuntimeError("driver already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="sparse-serve-driver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Halt the loop after the in-flight tick completes and join the
        thread. Queued tickets stay QUEUED (no implicit drain — see
        :meth:`drain`). Safe to call when already stopped."""
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        # An idle loop may be parked on the engine's work event; poke it.
        self.engine._work_event.set()
        thread.join(timeout)
        if thread.is_alive():
            raise RuntimeError("driver thread did not stop within timeout")
        self._thread = None

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every admitted request reaches a terminal status,
        while the loop keeps ticking. Requires a running driver (a
        stopped loop cannot drain — that wait would hang, so it raises
        ``RuntimeError`` instead). Raises ``TimeoutError`` if the queue
        is still non-empty after ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        while True:
            if not self.running:
                raise RuntimeError("driver is not running; cannot drain")
            if self.engine.pending() == 0:
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"engine did not drain within {timeout}s "
                    f"({self.engine.pending()} requests outstanding)"
                )
            time.sleep(self.drain_poll)

    def __enter__(self) -> "ServeDriver":
        if not self.running:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None and self.running:
                self.drain(timeout=60.0)
        finally:
            self.stop()

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        backoff = self.idle_backoff_min
        while not self._stop.is_set():
            worked = self.engine.step()
            self.ticks += 1
            if worked or self.engine.pending():
                backoff = self.idle_backoff_min
                if self.interval:
                    # Busy cadence throttle; stop() interrupts the wait.
                    self._stop.wait(self.interval)
                continue
            # Idle: park on the work event (submit() sets it) with
            # exponential backoff as a safety net against lost wakeups.
            self.engine.wait_for_work(backoff)
            backoff = min(backoff * 2.0, self.idle_backoff_max)
