#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from
(not run by the benchmark's own runs):

    python3 ccvs_bench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <k>] [--faults <fault> ...] [--fault-seeds <k>] [--seconds <s>]
        [--out <file.jsonl>]

For each seed: the program's sound run through the cell's own set-up (and
a window of ``--seconds``, 0 by default: one rollout, or no step past the
checked ones), its compared numbers against the fp32 reference; on the
first ``--control-seeds`` seeds the control's (the reference in fp8, put in
the program's place); and on the first ``--fault-seeds`` each planted
fault's. One JSON line a reading.
"""

import argparse
import importlib
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from ccvs_bench import common, harness  # noqa: E402


def readings(cell_name, seeds, control_seeds, faults, fault_seeds, seconds, witness=False,
             device="cuda"):
    """Yield ``{"seed", "side", "numbers"}`` for every seed and side."""
    cell = harness.find_cell(common.manifest(), cell_name)
    cfg, traffic, _ = common.cell_files(cell)
    entry = importlib.import_module(f"ccvs_bench.entries.{traffic['entry']}")
    for i, seed in enumerate(seeds):
        runs = {"program": entry.Run(cfg, traffic, seed, device)}
        if i < fault_seeds:
            runs.update({f: entry.Run(cfg, traffic, seed, device, fault=f) for f in faults})
        for side, run in runs.items():
            t0 = time.perf_counter()
            run.setup()
            run.window(seconds)
            run.free()
            t1 = time.perf_counter()
            numbers, info = run.judge(run.out, detail=True)
            t2 = time.perf_counter()
            print(f"seed {seed} {side}: set-up and window {t1 - t0:.1f} s, reference "
                  f"{t2 - t1:.1f} s", file=sys.stderr, flush=True)
            yield {"seed": seed, "side": side, "numbers": numbers, "reference_s": t2 - t1,
                   "detail": info}
            if side == "program" and i == 0 and witness:
                # the losses of a reference whose operands are rounded to bf16, on
                # the program's codes: a second witness of what bf16 computes
                yield {"seed": seed, "side": "bf16_witness", "program": run.out["losses"],
                       "bf16": run.reference("bf16", codes=run.out["codes"])["losses"]}
            if side == "program" and i < control_seeds:
                numbers, info = run.judge(run.reference("fp8"), detail=True)
                yield {"seed": seed, "side": "control", "numbers": numbers, "detail": info}
            common.free_cuda()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--witness", action="store_true",
                    help="on the first seed, a reference with bf16 operands (training)")
    ap.add_argument("--out")
    args = ap.parse_args()
    sink = open(args.out, "a") if args.out else None
    try:
        for rec in readings(args.workload, args.seeds, args.control_seeds, args.faults,
                            args.fault_seeds, args.seconds, args.witness):
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()


if __name__ == "__main__":
    main()
