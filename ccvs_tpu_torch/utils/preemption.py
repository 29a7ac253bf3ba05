"""Graceful preemption for long training runs (counterpart of
``ccvs_tpu/utils/preemption.py``).

A machine that is about to be reclaimed sends SIGTERM; the trainer finishes
the step in flight, writes a ``latest`` checkpoint and exits cleanly, so
``resume`` continues from the same iteration. Usage::

    with PreemptionGuard() as guard:
        for it in range(start, n_iter):
            ...train step...
            if guard.triggered:
                ckpt.save(..., latest=True)
                break

The guard only records the signal; the training loop decides when to act,
so the checkpoint is always written at a step boundary. One process only:
agreeing on the flag across processes comes with the parallel layer.
"""

import signal
import threading


class PreemptionGuard:
    """Context manager that latches SIGTERM/SIGINT into a boolean flag.

    Handlers are installed on ``__enter__`` and the previous handlers are
    restored on ``__exit__``, so nesting trainers (e.g. the CLI pipeline
    running AE then transformer training) behaves: the inner guard wins
    while active. A second signal while latched re-raises the default
    behaviour (propagates ``KeyboardInterrupt`` for SIGINT), so an
    impatient ctrl-C ctrl-C still kills the process.

    Only the main thread may install signal handlers (CPython rule); when
    entered from a worker thread the guard degrades to an inert flag that
    can still be set programmatically via :meth:`trigger` (used by tests
    and by external schedulers that poll a preemption notice instead of
    signalling).
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._triggered = threading.Event()
        self._prev = {}
        self._installed = False

    # -- flag API -----------------------------------------------------
    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    def trigger(self, signum=None):
        """Latch the flag (idempotent). Called by the signal handler; may
        also be called directly to request a save-and-exit."""
        first = not self._triggered.is_set()
        self._triggered.set()
        if first:
            name = signal.Signals(signum).name if signum is not None else "request"
            print(f"[preemption] caught {name}; will checkpoint and exit "
                  "at the next step boundary", flush=True)

    # -- signal plumbing ----------------------------------------------
    def _handler(self, signum, frame):
        if self._triggered.is_set():
            # second signal: restore + re-deliver default behaviour
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev if callable(prev) or prev in
                          (signal.SIG_IGN, signal.SIG_DFL) else signal.SIG_DFL)
            raise KeyboardInterrupt
        self.trigger(signum)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._prev[s] = signal.getsignal(s)
                signal.signal(s, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._installed = False
        return False
