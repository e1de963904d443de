"""A serving cell's load sweep: run its traffic at each load given and print
one line per load.

Open loop (``--rates``): per rate, the time to first token of the requests
due in the first and the last third of the window and the backlog at its
close.  The highest rate whose last third waits no longer than its first
and whose backlog does not grow is the knee; a cell is set at about 4/5
of it.  Closed loop (``--slots``): per slot count, as many clients as
slots, the tokens per second, the gap between tokens and the device
memory's peak.

    python3 portbench/sweep.py --workload granite-moe-3b.long-prompt \\
        --seconds 30 --rates 6,9,12,15 --seed 7
    python3 portbench/sweep.py --workload granite-moe-3b.chat \\
        --seconds 30 --slots 128,256,384 --seed 7
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
    ap.add_argument("--rates", default="")
    ap.add_argument("--slots", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    use_checkout()
    import torch

    loads = [("rate_per_s", float(r)) for r in args.rates.split(",") if r] + \
        [("slots", int(n)) for n in args.slots.split(",") if n]
    for key, value in loads:
        bench = Bench(ROOT, args.workload, args.seed, args.seconds, False, "cuda")
        if key == "slots":
            bench.cell["engine"]["slots"] = value
            bench.cell["traffic"].update(clients=value, pool=max(bench.cell["traffic"]["pool"],
                                                                 3 * value))
        else:
            bench.cell["traffic"]["rate_per_s"] = value
        torch.cuda.reset_peak_memory_stats()
        res = bench.driver.run(bench)
        rec = res["record"]
        due = rec["due_ttft"]
        third = args.seconds / 3
        first = [w for d, w in due if d < third]
        last = [w for d, w in due if d >= 2 * third]
        print(json.dumps({
            key: value, "requests": len(rec["ttft_s"]),
            "ttft_ms_p50_first_third": 1e3 * float(np.median(first)) if first else None,
            "ttft_ms_p50_last_third": 1e3 * float(np.median(last)) if last else None,
            "ttft_ms_p95": 1e3 * float(np.percentile(rec["ttft_s"], 95)) if rec["ttft_s"] else None,
            "itl_ms_p95": 1e3 * float(np.percentile(rec["itl_s"], 95)) if rec["itl_s"] else None,
            "backlog_at_close": rec["backlog_at_close"], "live_max": rec["live_max"],
            "output_tokens_per_s": rec["output_tokens"] / rec["window_s"],
            "memory_peak_bytes": res["memory_peak_bytes"], "correct": res["correct"],
            "logit_gap_mean": res["compared"]["logit_gap_mean"]["value"]}), flush=True)
        del bench, res, rec
    return 0


if __name__ == "__main__":
    sys.exit(main())
