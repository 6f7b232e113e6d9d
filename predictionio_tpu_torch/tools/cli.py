"""Command line of the port: ``train`` and ``deploy``.

    python -m predictionio_tpu_torch.tools.cli train \\
        --engine-dir predictionio_tpu_torch/templates/recommendation
    python -m predictionio_tpu_torch.tools.cli deploy \\
        --engine-dir predictionio_tpu_torch/templates/recommendation \\
        --batching --aot-buckets auto

``train`` trains the engine named in the engine directory's
``engine.json`` (or ``--variant``) on the app's events and records a
COMPLETED instance; ``deploy`` serves the latest COMPLETED instance (one
the JAX package's ``pio train`` wrote into the same ``PIO_HOME``
included). Both run on the CUDA card; ``--device cpu`` runs on the CPU
instead. The flags are the JAX CLI's flags for the options the port
has, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional


def _die(msg: str, code: int = 1) -> "NoReturn":  # type: ignore[name-defined]
    print(f"[error] {msg}", file=sys.stderr)
    raise SystemExit(code)


def _load_variant_file(engine_dir: str, variant: Optional[str]) -> Dict[str, Any]:
    path = variant or os.path.join(engine_dir, "engine.json")
    if not os.path.exists(path):
        _die(f"engine variant file not found: {path}")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def make_server(args: argparse.Namespace):
    """The EngineServer ``deploy`` runs, built from parsed flags."""
    from predictionio_tpu_torch.server.engine_server import EngineServer

    variant = _load_variant_file(args.engine_dir, args.variant)
    factory = variant.get("engineFactory") or _die("engine.json missing engineFactory")
    return EngineServer(
        engine_factory=factory,
        instance_id=args.engine_instance_id,
        host=args.ip, port=args.port,
        variant_id=str(variant.get("id", "")),
        batching=args.batching,
        batch_max=args.batch_max,
        batch_wait_ms=args.batch_wait_ms,
        aot_buckets=args.aot_buckets,
        aot_topk=args.aot_topk,
        device=args.device,
    )


def cmd_train(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch import ops
    from predictionio_tpu_torch.core.workflow import run_train

    variant = _load_variant_file(args.engine_dir, args.variant)
    factory = variant.get("engineFactory") or _die("engine.json missing engineFactory")
    iid = run_train(factory, variant=variant, batch=args.batch,
                    verbose=args.verbose, device=args.device)
    launches = ", ".join(f"{c.__name__}={c.launches}" for c in ops.LAUNCH_COUNTERS)
    print(f"[info] Training completed: engine instance {iid} "
          f"(kernel launches: {launches})")


def cmd_deploy(args: argparse.Namespace) -> None:
    server = make_server(args)
    print(f"[info] Engine Server (instance {server.deployed.instance.id}, "
          f"device {server.deployed.algorithms[0][1].device}) "
          f"listening on {args.ip}:{args.port}")
    server.run()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.tools.cli",
        description="PredictionIO on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)
    tp = sub.add_parser("train", help="train an engine instance")
    tp.add_argument("--engine-dir", default=".")
    tp.add_argument("-e", "--variant")
    tp.add_argument("--batch", default="", help="batch label of the instance")
    tp.add_argument("-v", "--verbose", action="count", default=0)
    tp.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; "
                         "'cpu' trains on the CPU)")
    tp.set_defaults(fn=cmd_train)
    dp = sub.add_parser("deploy", help="serve the latest trained instance")
    dp.add_argument("--engine-dir", default=".")
    dp.add_argument("-e", "--variant")
    dp.add_argument("--ip", default="0.0.0.0")
    dp.add_argument("--port", type=int, default=8000)
    dp.add_argument("--engine-instance-id")
    dp.add_argument("--batching", action="store_true",
                    help="micro-batch concurrent queries into one dispatch")
    dp.add_argument("--batch-max", type=int, default=64)
    dp.add_argument("--batch-wait-ms", type=float, default=0.0,
                    help="opt-in batch-formation wait; 0 = drain-only "
                         "continuous batching (default)")
    dp.add_argument("--aot-buckets", default=None,
                    help="warm the serving program for a ladder of padded "
                         "batch buckets at deploy time: 'auto' = geometric "
                         "1,2,4,..,batch-max; or an explicit comma list "
                         "e.g. '1,4,16,64' (its largest bucket becomes the "
                         "effective batch max). Queries answer 503 until "
                         "the ladder is warm; unset = no warmup")
    dp.add_argument("--aot-topk", type=int, default=16,
                    help="top-k width to warm the AOT ladder at (serving "
                         "k is bucketed up to this program shape)")
    dp.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; "
                         "'cpu' serves on the CPU)")
    dp.set_defaults(fn=cmd_deploy)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
