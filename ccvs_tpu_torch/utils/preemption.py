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
so the checkpoint is always written at a step boundary. Under
``torch.distributed`` the loop asks :meth:`PreemptionGuard.sync_triggered`,
so that every rank stops at the same iteration.
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

    def __init__(self, group=None):
        self._triggered = threading.Event()
        self._prev = {}
        self._installed = False
        self._group = group
        self._sync_calls = 0
        self._last_global = False

    # -- flag API -----------------------------------------------------
    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    def sync_triggered(self, every: int = 10) -> bool:
        """The flag agreed over the ranks of ``group`` (default: the default
        process group). The machines of a job get SIGTERM at slightly
        different times; a rank that stopped on its local flag would leave
        the others waiting in the next step's collectives. So every
        ``every``-th call all-reduces the local flags (MAX), and between
        those calls the last global value is returned, never the local flag;
        a stop comes at most ``every - 1`` steps late. Every rank calls this
        once a step, so the schedule agrees. One process: :attr:`triggered`,
        no collective."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size(self._group) == 1:
            return self.triggered
        self._sync_calls += 1
        if self._last_global or (self._sync_calls - 1) % max(1, every):
            return self._last_global
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(self._group) == "nccl" else torch.device("cpu")
        flag = torch.tensor([int(self.triggered)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
        self._last_global = bool(flag.item())
        return self._last_global

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
