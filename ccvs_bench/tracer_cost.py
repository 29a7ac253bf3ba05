#!/usr/bin/env python3
"""What the program's tracer (``ccvs_tpu_torch.utils.profiling``) costs
when it is on, without ``torch.profiler`` (not run by the benchmark's own
runs):

    python3 ccvs_bench/tracer_cost.py --workload <cell> --seed <n> [--runs 10]

One process sets the cell up as its runs do, then makes ``--runs`` of its
units of work (a rollout, or a training step: ``encode_batch`` and
``step``) back to back, the tracer off and on in turn (off first), each
timed on the host clock to the device's end. Prints one JSON line: the
seconds of each unit with the tracer off and on, their medians, the
on/off ratio of each adjacent pair, and the median host ms of each span
name over the units with the tracer on (``tokens.step``, ``tokens.sample``
...: what the per-layer metrics read, here without the profiler's cost).
"""

import argparse
import importlib
import json
import os
import statistics
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from ccvs_bench import common, harness, weights  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    from ccvs_tpu_torch.utils import profiling

    cell = harness.find_cell(common.manifest(), args.workload)
    cfg, traffic, _ = common.cell_files(cell)
    entry = importlib.import_module(f"ccvs_bench.entries.{traffic['entry']}")
    run = entry.Run(cfg, traffic, args.seed, "cuda")
    run.setup()
    if traffic["entry"] == "generate":
        def unit(i):
            run.vg.generate(run.pool[i % len(run.pool)],
                            weights.generator(run.device, args.seed, 20, i), rec=False,
                            fake=True)
    else:
        def unit(i):
            run._step(run.step_i + i)
    times = {"off": [], "on": []}
    span_ms = {}
    for i in range(args.runs):
        on = i % 2 == 1
        (profiling.enable if on else profiling.disable)()
        profiling.reset()
        t0 = common.synced(run.device)
        unit(i)
        times["on" if on else "off"].append(common.synced(run.device) - t0)
        if on:
            spans = profiling.spans()
            for name, start, end, _, _ in spans:
                span_ms.setdefault(name, []).append((end - start) / 1e6)
    profiling.disable()
    ratios = [b / a for a, b in zip(times["off"], times["on"])]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "unit_s": times,
                      "median_off_s": statistics.median(times["off"]),
                      "median_on_s": statistics.median(times["on"]),
                      "on_over_off_by_pair": ratios, "spans_a_unit": len(spans),
                      "span_host_ms_median": {k: statistics.median(v)
                                              for k, v in sorted(span_ms.items())},
                      "card": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
