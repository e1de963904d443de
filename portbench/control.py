"""Readings that set a cell's limits: for each seed, one short window of
the cell at its own load, then the cell's own check of the program and of
the control (the cell's reference in the precision below the one the
configuration states, judged in the program's place): the number compared
and ``correct`` for each.  One process for all seeds; the benchmark's own
runs never run this.

    python3 portbench/control.py --workload granite-moe-3b.long-prompt \
        --seconds 20 --control fp8 --seeds 101,202,303

Prints one JSON line per seed and a summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.run import Bench, use_checkout  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default="fp8")
    args = ap.parse_args(argv)
    use_checkout()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        bench = Bench(ROOT, args.workload, seed, args.seconds, False, "cuda")
        bench.control = args.control
        res = bench.driver.run(bench)
        ctl = res["control"]
        row = {"seed": seed, "program": res["compared"]["logit_gap_mean"]["value"],
               "program_correct": res["correct"],
               "control": ctl["compared"]["logit_gap_mean"]["value"],
               "control_correct": ctl["correct"],
               "tokens_checked": res["compared"]["tokens_checked"]["value"],
               "finished": res["finished"], "attempted": res["attempted"],
               "memory_peak_bytes": res["memory_peak_bytes"],
               "live_max": res["record"]["live_max"]}
        for side, gaps in res["gaps"].items():
            flat = np.concatenate([np.asarray(g, np.float64) for g in gaps])
            row[side + "_stats"] = {"widest": float(flat.max()), "mean": float(flat.mean()),
                                    "share_off_best": float((flat > 0).mean()),
                                    "p99": float(np.percentile(flat, 99)), "n": int(flat.size)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del bench, res
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "program_max": max(r["program"] for r in rows),
                      "control_min": min(r["control"] for r in rows),
                      "program_all_correct": all(r["program_correct"] for r in rows),
                      "control_none_correct": not any(r["control_correct"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
