"""The port's tracer, and profiling hooks (counterpart of
``ccvs_tpu/utils/profiling.py``): spans and counters at the layer
boundaries of generation and training, ``torch.profiler`` trace capture
and a completion barrier.

Spans are named intervals of the host's work, stamped with
``time.time_ns()``, the clock on which ``torch.profiler`` stamps its host
records (and, on a card, its device records): a span and the trace of the
same slice can be joined, each device operation to the runtime call that
launched it and that call to the spans around it. The tracer has one
switch, a module flag: :func:`enable` sets it, :func:`disable` clears it,
and a :func:`root` opened while it is clear and a ``torch.profiler``
session records sets it until that root closes, so that the spans of the
slice a profiler traces are there to join with its trace. Off,
:func:`span` is one check of the flag that returns a shared object that
does nothing. Spans recorded under a profiler alone are bounded: a root
that finds :data:`MAX_SPANS` of them starts the list anew. Counters
(:func:`count`) always count: a plain integer add.

The spans of the port (parent in brackets), each read by a per-layer
metric of the benchmark (``ccvs_bench/spans.py``):

- ``generate`` (a root): ``VideoGenerator.generate``,
  ``generate_step_by_step``;
- ``tokens``: ``TokenTransformer.generate``, ``generate_chunk_fixed``,
  ``ContinuousTransformer.generate``; ``tokens.step`` (``tokens``), each
  pass of a decode loop; ``tokens.sample`` (``tokens.step``), the choice of
  a position's tokens;
- ``decode``: ``FrameAutoencoder.decode_video``, ``decode_video_layout``
  (and each frame of ``generate_step_by_step``);
- ``train.encode`` (a root): ``TransformerTrainer.encode_batch``;
- ``train.step`` (a root): the step of ``make_transformer_step``;
  ``train.optimizer`` (``train.step``), its AdamW update.

The hand-written kernels count their launches: ``k1.launches`` (K1,
``ops/vq.py``), ``k2.launches`` (K2, ``ops/attention.py``) and
``k3.launches`` (K3, ``ops/int8_linear.py``).

The reference has no profiler integration (unprinted ``time.time()`` probes
only). A trace written by :func:`trace` is a Chrome trace
(``chrome://tracing`` or Perfetto), one file a capture.
"""

import contextlib
import functools
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# ---------------------------------------------------------------- the tracer

MAX_SPANS = 1 << 18  # spans a profiler alone keeps (~45 MB); a traced rollout records ~2,000
_on = False  # the switch: spans record
_spans = []  # [name, start_ns, end_ns, parent id, root id]; a span's id is its index
_open = []   # ids of the open spans, outermost first
_counters = {}


class _Off:
    """What :func:`span` returns while the tracer is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name):
        self.rec = [name, 0, None, None, None]

    def __enter__(self):
        rec, i = self.rec, len(_spans)
        rec[3], rec[4] = (_open[-1], _open[0]) if _open else (None, i)
        _spans.append(rec)
        _open.append(i)
        rec[1] = time.time_ns()
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        if _open:
            _open.pop()
        return False


class _ProfiledRoot(_Span):
    """A root opened while the tracer is off and a profiler records: the
    tracer is on until it closes."""

    __slots__ = ()

    def __enter__(self):
        global _on
        if len(_spans) >= MAX_SPANS:  # no span is open: the ids can start again
            _spans.clear()
        _on = True
        return super().__enter__()

    def __exit__(self, *exc):
        global _on
        super().__exit__(*exc)
        _on = False
        return False


def span(name):
    """A context manager over the host's work of ``name``: recorded while
    the tracer is on, with its parent (the innermost open span) and its
    root (the outermost)."""
    if not _on:
        return _OFF
    return _Span(name)


def root(name):
    """:func:`span` for the outermost span of one rollout or one training
    step; opened while a ``torch.profiler`` session records, it turns the
    tracer on until it closes."""
    if _on:
        return _Span(name)
    if getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return _ProfiledRoot(name)
    return _OFF


def spanned(name, is_root=False):
    """Decorator: every call of the function inside :func:`span` ``name``
    (:func:`root` with ``is_root``)."""
    opener = root if is_root else span

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with opener(name):
                return fn(*args, **kw)

        return inner

    return wrap


def count(name, n=1):
    """Add ``n`` (a host int) to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def enable():
    """Record every span from now on."""
    global _on
    _on = True


def disable():
    """Record no span from now on (until a root opens under a profiler)."""
    global _on
    _on = False


def reset():
    """Forget the spans and zero the counters (between roots: a span open
    now is not kept)."""
    _spans.clear()
    _open.clear()
    _counters.clear()


def spans():
    """The recorded spans in the order they opened, each ``(name,
    start_ns, end_ns, parent, root)``: ``parent`` and ``root`` are indices
    into this list (``parent`` None for a root), ``end_ns`` None while the
    span is open."""
    return [tuple(rec) for rec in _spans]


def counters():
    """``{name: count}`` of every counter counted since the last reset."""
    return dict(_counters)


# ---------------------------------------------------------------- capture


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    if isinstance(x, torch.nn.Module):
        return next(iter(x.parameters()), None)
    return None


def device_sync(x=None):
    """Wait for the work queued on the device of ``x`` (a tensor, a module,
    or a dict / list holding one); the current CUDA device when ``x`` holds
    none. Nothing to wait for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    elif t is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_trace():
    """A started ``torch.profiler`` capture of the CPU and (where there is
    one) the CUDA activity; end it with :func:`stop_trace`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str, name: str = "trace") -> str:
    """Wait for the device, stop ``prof`` and export its Chrome trace to
    ``log_dir/<name>.json`` (returned)."""
    device_sync()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = "trace"):
    """Capture a ``torch.profiler`` trace of the block into the Chrome trace
    ``log_dir/<name>.json``; a no-op when ``log_dir`` is None. Yields the
    profiler (``key_averages()`` for a table), or None."""
    if not log_dir:
        yield None
        return
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, name)
