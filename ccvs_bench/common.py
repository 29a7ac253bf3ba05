"""What every entry of the harness shares: the files a cell is made of, the
port's configuration built from a configuration file, timing on the
device, and the comparison numbers."""

import contextlib
import json
import os
import statistics
import time

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest():
    return read_json(ROOT, "BENCHMARK.json")


def cell_files(cell):
    """The configuration, traffic mix and limits of a ``workloads`` entry,
    found by name."""
    return (read_json(BENCH, "configs", cell["config"] + ".json"),
            read_json(BENCH, "traffic", cell["traffic"] + ".json"),
            read_json(BENCH, "limits", cell["name"] + ".json"))


def port_config(cfg):
    """The port's ``Config`` of a configuration file: its preset with the
    file's ``ae`` and ``gpt`` groups whole."""
    import dataclasses

    from ccvs_tpu_torch.config import get_config

    base = get_config(cfg["preset"])

    def group(obj, values):
        names = {f.name for f in dataclasses.fields(obj)}
        unknown = set(values) - names
        if unknown:
            raise ValueError(f"{cfg['name']}: the port has no field {sorted(unknown)}")
        return dataclasses.replace(obj, **{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in values.items()})

    return base.replace(ae=group(base.ae, cfg["ae"]), gpt=group(base.gpt, cfg["gpt"]))


def synced(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Spans:
    """Device-time spans by name: a pair of CUDA events around each call,
    read once the window is over (no synchronisation inside it)."""

    def __init__(self, on):
        self.on = on
        self.events = {}

    def wrap(self, obj, method, name):
        """Time every call of ``obj.method`` (on the instance) under ``name``."""
        inner = getattr(obj, method)

        def timed(*args, **kw):
            with self.span(name):
                return inner(*args, **kw)

        setattr(obj, method, timed)

    @contextlib.contextmanager
    def span(self, name):
        if not self.on:
            yield
            return
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        yield
        pair[1].record()
        self.events.setdefault(name, []).append(pair)

    def ms(self):
        """``{name: [ms of each call]}``."""
        if self.events:
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


def worst_leaf_gap(prog, ref, keep):
    """The worst leaf's gap between two norms, over the leaves ``keep``:
    ``|prog - ref|`` over the larger of the reference's norm of that leaf
    and of the median leaf."""
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def free_cuda():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
