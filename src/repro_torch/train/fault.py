"""Fault tolerance: step watchdog + restart-from-checkpoint supervisor
(the port's copy of ``repro.train.fault``; plain Python).

On a real multi-pod deployment the failure modes are (a) a host dies ->
the coordinator re-launches and every process restores from the latest
checkpoint, possibly onto a smaller mesh (elastic), and (b) a straggler
holds the step hostage -> a deadline fires and the step is treated as
failed. Both reduce to the same control flow, which is what we implement
and test here:

  run_with_restarts(body)  — calls ``body(restart_count)``; on any
      exception (including WatchdogTimeout) re-invokes up to
      ``max_restarts`` times. ``body`` is responsible for restoring from
      the CheckpointManager (see train_loop).

  Watchdog — wraps a step callable; if a step's wall time exceeds the
      deadline the *next* call raises WatchdogTimeout. (CUDA launches are
      asynchronous; the train loop's step ends in the loss's ``.item()``,
      the blocking fetch where a hung kernel or collective manifests.)
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class WatchdogTimeout(RuntimeError):
    pass


class Watchdog:
    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s

    def run(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under a deadline. Returns its result or raises
        WatchdogTimeout. The runaway thread is abandoned (daemonized) —
        on real hardware the process would be killed by the supervisor."""
        result: list = [None]
        error: list = [None]
        done = threading.Event()

        def target():
            try:
                result[0] = fn()
            except BaseException as e:          # noqa: BLE001
                error[0] = e
            finally:
                done.set()

        t = threading.Thread(target=target, daemon=True)
        t.start()
        if not done.wait(self.timeout_s):
            raise WatchdogTimeout(
                f"step exceeded {self.timeout_s}s deadline (straggler/hang)")
        if error[0] is not None:
            raise error[0]
        return result[0]


def run_with_restarts(body: Callable[[int], Any], max_restarts: int = 10,
                      on_restart: Optional[Callable[[int, BaseException],
                                                    None]] = None) -> Any:
    """Supervisor loop: call ``body(attempt)``; restart on failure."""
    attempt = 0
    while True:
        try:
            return body(attempt)
        except BaseException as e:              # noqa: BLE001
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
