"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``entry``
names the general entry for that kind of work in ``entries/``),
``limits/<cell>.json`` and ``metrics/<metric>.py`` (a ``read(readings)``
that returns the metric's value, or None where it finds nothing to read).
"""

import argparse
import importlib
import importlib.util
import json
import os
import sys

from ccvs_bench import common

# top-level modules the measured process must not hold once the window is over
FORBIDDEN = ("jax", "jaxlib", "flax", "ccvs_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def find_cell(man, name):
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(man, cell, trace):
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    name = cell["name"]
    if not trace:
        return [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in cell_metrics(man, cell, False)}
    return [m for m in man["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def read_metric(name, readings):
    path = os.path.join(common.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("ccvs_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(torch, peak):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure(run, seconds, limits, t_start):
    """Set-up, the window, then the check once the program is freed: the
    window's figures, the peak memory of the window, the readings of the
    per-layer metrics, each compared number beside its limit, and whether
    every one is within it."""
    import torch

    cuda = run.device.type == "cuda"
    run.setup()
    setup_s = common.synced(run.device) - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = run.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    readings = run.readings() if run.trace else None
    run.free()
    numbers = run.check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return {"setup_s": setup_s, "window": win, "peak": peak, "readings": readings,
            "checks": checks, "correct": all(c["value"] <= c["limit"] for c in checks.values())}


def main(argv, t_start):
    args = parse(argv)
    man = common.manifest()
    cell = find_cell(man, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cfg, traffic, limits = common.cell_files(cell)
    entry = importlib.import_module(f"ccvs_bench.entries.{traffic['entry']}")
    run = entry.Run(cfg, traffic, args.seed, "cuda", trace=bool(args.trace))
    out = measure(run, args.seconds, limits, t_start)
    found = forbidden_modules()
    if found:
        print(f"the measured process holds {found}", file=sys.stderr)
        return 3
    win, checks, readings = out["window"], out["checks"], out["readings"]

    metrics = {}
    for m in cell_metrics(man, cell, args.trace):
        if args.trace:
            value = read_metric(m["name"], readings)
        else:
            value = {"setup_s": out["setup_s"], traffic["rate_metric"]: win["rate"]}.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": out["correct"], "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device_block(torch, out["peak"])}
    if args.trace and readings["trace"] is not None:
        tr = readings["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        print(f"trace reduced in {tr.reduce_s:.2f} s from {len(tr.kernels)} device and "
              f"{len(tr.host_ops)} host events", file=sys.stderr)
    result["checks"] = checks
    print(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
