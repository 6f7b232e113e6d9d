"""The benchmark of predictionio_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port. The cell's
configuration, traffic mix and per-layer metrics are found by name
(``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``) from ``BENCHMARK.json``; the mix names the
driver that runs it. A run sets up (timed as ``setup_s``, from the
process's start), measures for ``--seconds``, then checks what the
window produced against the plain reference and prints one JSON line
last on standard output. With ``--trace 1`` the window runs under
torch.profiler and the line carries the per-layer metrics, the device's
busy and window seconds and a breakdown.

It exits non-zero and prints no result when there is no CUDA card (or
fewer than the cell asks for), when the port is not in the checkout, or
when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchlib import common  # noqa: E402
from benchlib.common import log  # noqa: E402

DRIVERS = {
    "als_train_loop": ("benchlib.drive_als", "AlsTrainLoop"),
    "batchpredict": ("benchlib.drive_ann", "BatchPredict"),
}


def read_metric(name: str, ctx: dict):
    """The per-layer metric ``name`` from its reader ``metrics/<name>.py``;
    None when the reader finds nothing to read."""
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             spec=None, man=None, control: bool = False, t_start: float = _T_START):
    """One run of a cell: (result line's dict fields, checks). ``spec``
    (workload, configuration, mix) replaces the manifest's, and
    ``device`` the card, for the CPU tests only."""
    import importlib

    import torch

    common.import_program()
    man = man or common.manifest()
    wl, cfg, mix = spec or common.cell_spec(workload, man)
    e2e_defs, layer_defs = common.cell_metrics(workload, man)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        log(f"card: {common.card_record()}")
    mod_name, cls_name = DRIVERS[mix["driver"]]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    clock = common.Clock(t_start)
    seed = common.seed_int(seed)
    driver = cls(cfg, mix, seed, dev, clock, control=control)
    driver.setup()
    from benchlib.tracing import Profiler

    t_window = time.perf_counter()
    with Profiler(trace, str(common.RUN_DIR / "trace.json")) as prof:
        driver.run_window(seconds)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    setup_s = getattr(driver, "window_t0", t_window) - t_start
    log(f"setup: {setup_s:.3f} s in all; window {driver.window_s:.3f} s")
    e2e = dict(driver.end_to_end(), setup_s=setup_s)
    device_rec = common.device_record(dev)
    ctx, breakdown = None, None
    if trace:
        tr = prof.read()
        ctx = dict(driver.layer_context(), trace=tr, window_s=driver.window_s)
        device_rec["busy_s"] = tr.busy_s
        device_rec["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    driver.release()
    gc.collect()
    checks = driver.check()
    attempted, failed = driver.attempted, driver.failed
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    metrics = {}
    if trace:
        for m in layer_defs:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e_defs:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    correct = all(v is not None and math.isfinite(v) and v <= lim
                  for v, lim in checks.values())
    fields = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_rec, "breakdown": breakdown}
    return fields, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.prepare_environment()
    man = common.manifest()
    wl, _, _ = common.cell_spec(args.workload, man)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        log(f"the cell needs {wl['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    fields, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), man=man)
    found = common.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded in this process: {', '.join(found)}")
        return 3
    for name, (v, lim) in checks.items():
        log(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v is not None and v <= lim else 'FAIL'}")
    print(common.result_line(fields["correct"], fields["attempted"], fields["failed"],
                             fields["metrics"], fields["device"], checks,
                             fields["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
