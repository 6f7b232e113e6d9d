"""The control and the readings that set each check's limits.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--program]

Runs the cell once a seed in this one process, each run a short window
at the cell's own sizes and load, and prints each seed's checks as a JSON
line. Without ``--program`` it runs the control: the same cell computed
one precision below the configuration's (TF32 for the float32 products:
the program's own TF32 path with its float32 guard taken out, and for
the two-tower cells the reference's tower in TF32 in the program's
place), which the checks must refuse. With ``--program`` it runs the
program as the benchmark does, for the lower readings; with ``--fault
<name>`` the program with one of ``benchlib/faults.py``'s faults planted
underneath. The benchmark's own runs never run any of these.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchlib import common, faults  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    common.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        common.log("no CUDA device")
        return 2
    mode = "program" if args.program else "control"
    plant = contextlib.nullcontext
    if args.fault:
        mode = f"fault:{args.fault}"
        plant = faults.FAULTS[common.cell_spec(args.workload)[2]["driver"]][args.fault]
    for seed in args.seeds:
        t0 = time.perf_counter()
        with plant():
            fields, checks = run.run_cell(args.workload, seed, args.seconds, False,
                                          control=mode == "control", t_start=t0)
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                          "correct": fields["correct"], "attempted": fields["attempted"],
                          "checks": {k: v for k, (v, _) in checks.items()},
                          "limits": {k: lim for k, (_, lim) in checks.items()},
                          "card": common.card_record()}), flush=True)
    found = common.forbidden_loaded()
    if found:
        common.log(f"forbidden modules loaded in this process: {', '.join(found)}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
