#!/usr/bin/env python3
"""Phase 8's serving numbers, side by side for several checkouts, on one card.

    python3 serving_ab.py --tree build/parent --tree . [--rounds 8] [--seed 7]
                          [--after-phases] [--log-dir build/serving_ab]

Each tree is the root of a checkout that holds ``chip_smoke.py`` and the
port. One set of factors at phase 8's shape (138,493 users x 26,744 items,
rank 64) is drawn from ``--seed`` and saved once. Each round then runs
every tree once, each in a fresh process started from that tree's root,
in an order that changes from round to round (every permutation in turn),
so that no tree always runs first or last. A run calls the tree's own
``chip_smoke.drive_server`` on those factors: the instance written, the
EngineServer deployed on the card with micro-batching and the AOT ladder,
200 sequential queries, a burst of 512 over 64 clients, 96 sequential
queries with num > 32, and every answer held against the plain reference
(a run whose answers disagree fails). The run's process builds the
tree's kernels first (once per tree: the libraries stay under its
``build/``). With ``--after-phases`` each run is instead the tree's own
phases 3-8 in one process, as ``python3 chip_smoke.py`` runs them (the
kernel checks and timings, the full-width training, the quickstart
through the CLI), so that phase 8 serves the factors phase 5 trained in
the state those phases leave behind; a run then takes minutes.

Prints one JSON line a run (tree, round, position, sequential p50 and
p99, burst p50 and q/s, the num > 32 sub-run's p50), then one line a
tree with the medians, and, for every tree after the first, the per-round
differences from the first tree and how many rounds it was slower in.
Needs one CUDA card; exits non-zero without one or when a run fails.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

# phase 8's shape (chip_smoke.N_USERS, N_ITEMS, RANK)
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64

CHILD = r"""
import sys, tempfile
tree, u_path, v_path, after = sys.argv[1:5]
sys.path.insert(0, tree)
import numpy as np
import torch
import chip_smoke as cs
from predictionio_tpu_torch import ops
from predictionio_tpu_torch.ops import _build
_build.build(ops.KERNELS)
dev = torch.device("cuda", 0)
if after == "1":
    for check in (cs.check_score_topk, cs.check_gather_gram, cs.check_chol_solve,
                  cs.check_rows_gram, cs.time_score_topk):
        check(torch, ops, dev)
    train = cs.train_full_width(torch, ops, dev)
    cs.time_training_kernels(torch, ops, dev, train)
    cs.time_rows_gram(torch, ops, dev, train)
    cs.quickstart_through_cli(torch, ops, dev)
    U, V = train["U"], train["V"]
else:
    U, V = np.load(u_path), np.load(v_path)
with tempfile.TemporaryDirectory(prefix="pio_serving_ab_") as home:
    cs.drive_server(torch, ops, dev, home, U, V)
"""

QUERIES = re.compile(
    r"queries: \d+ sequential p50=([\d.]+) ms p99=([\d.]+) ms; burst of \d+ over "
    r"\d+ clients p50=([\d.]+) ms p99=([\d.]+) ms \(([\d.]+) q/s\)")
WIDE = re.compile(r"queries with num > 32: \d+ sequential p50=([\d.]+) ms")
KEYS = ("seq_p50_ms", "seq_p99_ms", "burst_p50_ms", "burst_p99_ms", "burst_qps",
        "wide_p50_ms")


def run_once(tree: str, u_path: str, v_path: str, after: bool,
             log_path: str | None) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, tree, u_path, v_path, "1" if after else "0"],
        cwd=tree, capture_output=True, text=True, timeout=1800)
    if log_path:
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: run failed ({proc.returncode}):\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    q, w = QUERIES.search(proc.stdout), WIDE.search(proc.stdout)
    if q is None or w is None:
        raise SystemExit(f"{tree}: no serving numbers in its output:\n{proc.stdout[-2000:]}")
    return dict(zip(KEYS, [float(x) for x in q.groups()] + [float(w.group(1))]))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="root of a checkout (give two or more)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--after-phases", action="store_true",
                    help="run each tree's phases 3-7 before its phase 8")
    ap.add_argument("--log-dir", default=None,
                    help="write each run's whole output here")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device is available", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in args.tree]
    for t in trees:
        if not os.path.isfile(os.path.join(t, "chip_smoke.py")):
            print(f"serving_ab: {t} holds no chip_smoke.py", file=sys.stderr)
            return 2
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    rng = np.random.default_rng(args.seed)
    runs = {t: [] for t in trees}
    orders = list(itertools.permutations(range(len(trees))))
    with tempfile.TemporaryDirectory(prefix="pio_serving_ab_") as tmp:
        u_path, v_path = os.path.join(tmp, "U.npy"), os.path.join(tmp, "V.npy")
        np.save(u_path, (rng.standard_normal((N_USERS, RANK)) * 0.3).astype(np.float32))
        np.save(v_path, (rng.standard_normal((N_ITEMS, RANK)) * 0.3).astype(np.float32))
        for r in range(args.rounds):
            for pos, i in enumerate(orders[r % len(orders)]):
                log = (os.path.join(args.log_dir, f"r{r}_t{i}.log")
                       if args.log_dir else None)
                got = run_once(trees[i], u_path, v_path, args.after_phases, log)
                runs[trees[i]].append(got)
                print(json.dumps({"tree": args.tree[i], "round": r, "position": pos,
                                  **got}), flush=True)

    base = trees[0]
    for i, t in enumerate(trees):
        med = {k: statistics.median(x[k] for x in runs[t]) for k in KEYS}
        line = {"tree": args.tree[i], "runs": len(runs[t]), "median": med}
        if t != base:
            diffs = {k: [b[k] - a[k] for a, b in zip(runs[base], runs[t])]
                     for k in ("seq_p50_ms", "burst_qps", "wide_p50_ms")}
            line["minus_first"] = {k: {
                "per_round": [round(d, 4) for d in v],
                "median": statistics.median(v),
                "rounds_above": sum(d > 0 for d in v)} for k, v in diffs.items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
