"""Command line of the port: the quickstart's verbs.

    python -m predictionio_tpu_torch.tools.cli app new MyApp1
    python -m predictionio_tpu_torch.tools.cli eventserver --ingest-batching
    python -m predictionio_tpu_torch.tools.cli train \\
        --engine-dir predictionio_tpu_torch/templates/recommendation
    python -m predictionio_tpu_torch.tools.cli deploy \\
        --engine-dir predictionio_tpu_torch/templates/recommendation \\
        --batching --aot-buckets auto
    python -m predictionio_tpu_torch.tools.cli eval \\
        predictionio_tpu_torch.templates.recommendation.engine:RecEvaluation \\
        predictionio_tpu_torch.templates.recommendation.engine:DefaultGrid \\
        --distributed

Verbs:

- ``app`` (``new``, ``list``, ``show``, ``delete``, ``data-delete``,
  ``channel-new``, ``channel-delete``) and ``accesskey`` (``new``,
  ``list``, ``delete``) manage apps, access keys and channels;
- ``eventserver`` serves the event REST API (``server/event_server.py``);
  with ``--lease-home DIR`` it joins the replicated event plane
  (``server/repl_server.py``): nodes elect a leader over the lease file
  there, the leader streams its event log to ``--replicate-to`` peers
  before acking, followers 307 writers to the leader and take over when
  its lease lapses (``--advertise-url``, ``--lease-ttl``);
- ``import`` and ``export`` move an app's events from and to JSONL;
- ``train`` trains the engine named in the engine directory's
  ``engine.json`` (or ``--variant``) on the app's events and records a
  COMPLETED instance; ``--resume`` continues an interrupted train from
  the port's own mid-train checkpoints (``<home>/train_ckpt_torch``);
  ``--read-from follower|any --replica-home DIR`` trains from a
  replicated follower's home; ``--continuous`` runs the lease-fenced
  delta-train, gate, promote, ``/reload`` and bake loop
  (``server/trainer.py``), ``--max-cycles N`` wake cycles or until
  SIGTERM;
- ``daemon [flags] -- VERB ...`` supervises a verb of this CLI (crash
  restart with backoff, health checks, pidfile; ``tools/supervise.py``);
- ``failover --drill`` runs the kill -9 drill of two replicated event
  servers and prints its proof document; ``failover --target URL``
  promotes a follower by hand;
- ``batchpredict`` answers a JSONL file of queries with the latest
  COMPLETED instance (or ``--engine-instance-id``) into a JSONL file of
  ``{"query", "prediction"}`` lines, ``--batch-size`` queries a dispatch,
  ``--shards N`` serving ANN-indexed engines item-sharded over N slots;
- ``deploy`` serves the latest COMPLETED instance (one the JAX
  package's ``pio train`` wrote into the same ``PIO_HOME`` included);
- ``eval`` runs an Evaluation over a generator's grid, serially or
  ``--distributed`` (``core/sweep.py``), and records an evaluation
  instance with its leaderboard; ``eval leaderboard`` and ``evals
  list|show`` read those back (SQLite and JSON only: they import no
  torch);
- ``status`` checks the storage backends and the card;
- ``trace`` reads the span JSONL that ``eventserver`` and ``deploy``
  write with ``--tracing`` (the JAX package's format: either package's
  ``trace`` reads the other's file);
- ``app quota`` shows or sets an app's QoS overrides in ``quotas.json``
  (ingest rate and burst, fair-share weight), which both servers
  hot-reload;
- ``models list|promote|rollback`` read and move the model registry's
  champion (``<home>/model_registry``, the JAX package's manifest);
- ``variants status|set-weights`` read and re-split a live ``deploy
  --variants`` server's arms over HTTP, probe-then-apply;
- ``incidents list|show|prune`` browse the incident bundles the servers
  write (``--incident-dir``, on by default under ``<home>/incidents``);
  ``doctor`` ranks the findings of a bundle (``--incident ID|latest``)
  or of a live router and exits 0 clean, 1 warnings, 2 firing;
  ``--act`` prints the remediation plan of ``conf/remediations.json``'s
  playbooks, which ``--yes`` executes;
- ``router serve|status|reload [--rolling]`` runs and operates the fleet
  router (``server/router.py``) over ``deploy`` replicas: ``serve
  --pool-spawn 'deploy ... --port {port}' --manifest F`` owns the
  replicas (``tools/supervise.ReplicaPool``), with the autoscaler
  (``server/autoscale.py``) and the remediation engine
  (``server/remediate.py``) unless ``--no-autoscale``; ``slo status``
  (exit 1 while an SLO fast-burns) and ``top [--once] [--json]
  [--watch N]`` read the router's burn rates and federated history;
- ``dashboard`` serves the evaluation instances on :9000 and
  ``adminserver`` the REST admin API on :7071;
- ``undeploy`` stops a running ``deploy`` (``GET /stop``);
- ``template list|new NAME DIR`` lists the engine templates and copies
  one's ``engine.json`` into a new engine directory; ``build`` checks an
  engine directory (``engine.json`` parses, the factory resolves, the
  params bind); ``run module:callable [ARGS]`` calls a function with the
  engine directory on ``sys.path``; ``shell`` opens a Python prompt with
  the storage, ``data/store`` and the port's ``pypio`` loaded;
- ``version`` (and ``--version``) prints the package's version;
- ``index status [--engine-instance-id ID] [--json] [--shards N]``
  prints a trained instance's PQ index manifests (geometry, bytes, the
  digest verdict, a per-shard layout) from its files alone, without
  torch;
- ``fsck [--home H] [--repair] [--json]`` checks every persisted
  artifact of a home (event-log segments and their sidecars, the
  snapshot cache, model blobs, ANN index blobs, the model registry) and
  exits 0 clean, 1 on an operational error, 2 corrupt, 3 repaired;
- ``lint [--rule PLxx] [--json] [--no-baseline] [--baseline F]
  [--root DIR]`` runs the static invariant analysis
  (``analysis/``) over the port's tree against the reviewed baseline
  ``conf/lint-baseline-torch.json``, and exits 0 when every finding is
  baselined or suppressed, 1 otherwise (stdlib ``ast`` only: no torch);
- ``segments [status|show|roll|compact|ship] [--json] [--verify]``
  shows and operates the EVENTLOG backend's segmented log; ``train
  --no-scan-cache`` bypasses the columnar snapshot cache and
  ``eventserver --segment-maintenance`` compacts and ships sealed
  segments in the background.

The verbs print the JAX CLI's lines and write the same rows, so either
package's CLI works on a ``PIO_HOME`` the other wrote. ``train``,
``deploy``, ``batchpredict``, ``eval`` and ``status`` run on the CUDA
card and exit non-zero without one; ``--device cpu`` runs them on the
CPU instead. ``train`` trains over the device mesh of the variant's
``meshConf`` (sharded ALS over more than one slot; ``--no-mesh`` for one
device), and under the ``PIO_COORDINATOR_ADDRESS``/``PIO_NUM_PROCESSES``/
``PIO_PROCESS_ID`` variables one process a host trains together
(``parallel/distributed.py``). The
flags are the JAX CLI's flags for the options the port has, plus
``--device``: ``deploy --variants SPEC --feedback-url URL
--feedback-accesskey KEY`` serves a champion and a challenger side by
side and posts every answer back as a ``predict`` event.

Every verb runs on whichever backends ``PIO_STORAGE_REPOSITORIES_*`` and
``PIO_STORAGE_SOURCES_*`` select (``storage/registry.py``: SQLITE,
MEMORY, EVENTLOG, PGSQL, MYSQL, ELASTICSEARCH, LOCALFS, S3, HDFS), and
``status`` opens and checks each of the three repositories.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.storage.registry import get_storage
from predictionio_tpu_torch.version import __version__


def _die(msg: str, code: int = 1) -> "NoReturn":  # type: ignore[name-defined]
    print(f"[error] {msg}", file=sys.stderr)
    raise SystemExit(code)


def _load_variant_file(engine_dir: str, variant: Optional[str]) -> Dict[str, Any]:
    path = variant or os.path.join(engine_dir, "engine.json")
    if not os.path.exists(path):
        _die(f"engine variant file not found: {path}")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


# -- app, accesskey ---------------------------------------------------------


def cmd_app(args: argparse.Namespace) -> None:
    st = get_storage()
    meta = st.meta
    if args.app_cmd == "new":
        if meta.get_app_by_name(args.name):
            _die(f"app {args.name!r} already exists")
        app = meta.create_app(args.name, args.description or "")
        st.events.init_channel(app.id)
        ak = meta.create_access_key(app.id, key=args.access_key)
        print(f"[info] Created app {app.name!r} (id {app.id}).")
        print(f"[info] Access Key: {ak.key}")
    elif args.app_cmd == "list":
        for app in meta.list_apps():
            keys = meta.list_access_keys(app.id)
            print(f"{app.id:>6}  {app.name:<24} keys={len(keys)}  {app.description}")
    elif args.app_cmd == "show":
        app = meta.get_app_by_name(args.name) or _die(f"no app {args.name!r}")
        print(f"id={app.id} name={app.name} description={app.description!r}")
        for ak in meta.list_access_keys(app.id):
            events = ",".join(ak.events) or "(all)"
            print(f"  accesskey {ak.key}  events={events}")
        for ch in meta.list_channels(app.id):
            print(f"  channel {ch.id}: {ch.name}")
    elif args.app_cmd == "delete":
        app = meta.get_app_by_name(args.name) or _die(f"no app {args.name!r}")
        for ch in meta.list_channels(app.id):
            st.events.remove_channel(app.id, ch.id)
        st.events.remove_channel(app.id)
        meta.delete_app(app.id)
        print(f"[info] Deleted app {args.name!r}.")
    elif args.app_cmd == "data-delete":
        app = meta.get_app_by_name(args.name) or _die(f"no app {args.name!r}")
        if args.channel:
            ch = meta.get_channel_by_name(app.id, args.channel) or _die(
                f"no channel {args.channel!r}")
            st.events.wipe(app.id, ch.id)
        else:
            st.events.wipe(app.id)
        print(f"[info] Wiped event data of app {args.name!r}.")
    elif args.app_cmd == "channel-new":
        app = meta.get_app_by_name(args.name) or _die(f"no app {args.name!r}")
        ch = meta.create_channel(app.id, args.channel)
        st.events.init_channel(app.id, ch.id)
        print(f"[info] Created channel {ch.name!r} (id {ch.id}) in app {app.name!r}.")
    elif args.app_cmd == "channel-delete":
        app = meta.get_app_by_name(args.name) or _die(f"no app {args.name!r}")
        ch = meta.get_channel_by_name(app.id, args.channel) or _die(
            f"no channel {args.channel!r}")
        st.events.remove_channel(app.id, ch.id)
        meta.delete_channel(ch.id)
        print(f"[info] Deleted channel {args.channel!r}.")
    elif args.app_cmd == "quota":
        # torch-free: writes quotas.json next to the event
        # data; every server hot-reloads it within ~1s of the edit
        from predictionio_tpu_torch.server.tenancy import TenantQuotas

        app = meta.get_app_by_name(args.name) or _die(f"no app {args.name!r}")
        quotas = (TenantQuotas(args.quotas_file) if args.quotas_file
                  else TenantQuotas.for_home(st.config.home))
        fields: Dict[str, Any] = {}
        if args.rate is not None:
            fields["rate"] = args.rate
        if args.burst is not None:
            fields["burst"] = args.burst
        if args.weight is not None:
            fields["weight"] = args.weight
        if args.writer_shards is not None:
            fields["writer_shards"] = args.writer_shards
        if args.deadline_ms is not None:
            fields["deadline_ms"] = args.deadline_ms
        for k in args.clear or []:
            fields[k.replace("-", "_")] = None
        if fields:
            quotas.set_quota(str(app.id), **fields)
            print(f"[info] Updated quota overrides for app "
                  f"{app.name!r} (id {app.id}) in {quotas.path}.")
        eff = quotas.describe(str(app.id))
        print(json.dumps({"app": app.name, "appId": app.id,
                          "effective": eff}, indent=2, sort_keys=True))


def cmd_accesskey(args: argparse.Namespace) -> None:
    meta = get_storage().meta
    if args.ak_cmd == "new":
        app = meta.get_app_by_name(args.app_name) or _die(f"no app {args.app_name!r}")
        events = args.events.split(",") if args.events else []
        ak = meta.create_access_key(app.id, events=[e for e in events if e])
        print(f"[info] Access Key: {ak.key}")
    elif args.ak_cmd == "list":
        app = meta.get_app_by_name(args.app_name) if args.app_name else None
        for ak in meta.list_access_keys(app.id if app else None):
            events = ",".join(ak.events) or "(all)"
            print(f"{ak.key}  app={ak.app_id}  events={events}")
    elif args.ak_cmd == "delete":
        if not meta.delete_access_key(args.key):
            _die("no such access key")
        print("[info] Deleted access key.")


# -- servers --------------------------------------------------------------------


def _configure_tracing(args: argparse.Namespace) -> None:
    """Arm the process-wide tracer from the shared server flags."""
    if getattr(args, "access_log", False):
        import logging

        # the access log emits at INFO on "pio.access"; without a
        # handler the stdlib lastResort (WARNING+) would drop every line
        lg = logging.getLogger("pio.access")
        if not lg.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter("%(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.INFO)
            lg.propagate = False
    if not getattr(args, "tracing", False):
        return
    from predictionio_tpu_torch.storage.registry import StorageConfig
    from predictionio_tpu_torch.utils import tracing

    path = args.trace_file
    if path is None:
        path = tracing.default_trace_path(StorageConfig.from_env().home)
    tracing.TRACER.configure(
        enabled=True,
        sample_rate=args.trace_sample,
        slow_query_ms=args.slow_query_ms,
        jsonl_path=path or None,
    )
    print(f"[info] tracing enabled (sample={args.trace_sample}, "
          f"file={path or '(ring only)'})")


def make_event_server(args: argparse.Namespace):
    """The EventServer ``eventserver`` runs, built from parsed flags
    (with its ``ReplNode`` when ``--lease-home`` is set)."""
    from predictionio_tpu_torch.server.event_server import EventServer

    replication = None
    if args.lease_home:
        from predictionio_tpu_torch.server.repl_server import ReplNode
        from predictionio_tpu_torch.storage.registry import StorageConfig

        ip = args.ip if args.ip not in ("0.0.0.0", "::") else "127.0.0.1"
        advertise = args.advertise_url or f"http://{ip}:{args.port}"
        replication = ReplNode(
            lease_home=args.lease_home,
            advertise_url=advertise,
            home=StorageConfig.from_env().home,
            replicate_to=args.replicate_to,
            lease_ttl=args.lease_ttl)
    return EventServer(host=args.ip, port=args.port, stats=args.stats,
                       ingest_batching=args.ingest_batching,
                       ingest_max_batch=args.ingest_max_batch,
                       ingest_queue_depth=args.ingest_queue_depth,
                       auth_cache_ttl=args.auth_cache_ttl,
                       durable_acks=args.durable_acks,
                       access_log=args.access_log,
                       segment_maintenance=args.segment_maintenance,
                       tenant_quotas=args.tenant_quotas,
                       incident_dir=_incident_dir(args),
                       replication=replication)


def cmd_eventserver(args: argparse.Namespace) -> None:
    _configure_tracing(args)
    server = make_event_server(args)
    mode = "group-commit" if args.ingest_batching else "per-event commit"
    if server.repl is not None:
        mode += f", replicated event plane ({server.repl.advertise_url})"
    print(f"[info] Event Server listening on {args.ip}:{args.port} ({mode})",
          flush=True)
    server.run()


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
        feedback=args.feedback,
        feedback_url=args.feedback_url,
        feedback_access_key=args.feedback_accesskey,
        feedback_channel=args.feedback_channel,
        batching=args.batching,
        batch_max=args.batch_max,
        batch_wait_ms=args.batch_wait_ms,
        aot_buckets=args.aot_buckets,
        aot_topk=args.aot_topk,
        query_timeout_ms=args.query_timeout_ms,
        max_inflight=args.max_inflight,
        access_log=args.access_log,
        variants=args.variants,
        variant_salt=args.variant_salt,
        tenant_quotas=args.tenant_quotas,
        incident_dir=_incident_dir(args),
        device=args.device,
    )


def cmd_train(args: argparse.Namespace) -> None:
    if args.scan_workers:
        # the segment-scan fan-out of this run; the EVENTLOG store reads
        # it wherever the Storage is built
        os.environ["PIO_SCAN_WORKERS"] = str(args.scan_workers)
    if args.read_from != "leader":
        from predictionio_tpu_torch.data.replication import select_read_home
        from predictionio_tpu_torch.storage.registry import pio_home

        home = select_read_home(args.read_from, pio_home(), args.replica_home)
        # the storage home is resolved from the env wherever the Storage
        # is built: repoint it at the replicated copy
        os.environ["PIO_HOME"] = home
        print(f"[info] Training reads from {args.read_from} home: {home}")
    if args.read_from != "leader" or args.continuous:
        _read_through_view()
    variant = _load_variant_file(args.engine_dir, args.variant)
    factory = variant.get("engineFactory") or _die("engine.json missing engineFactory")
    if args.continuous:
        _run_continuous(args, variant, factory)
        return
    from predictionio_tpu_torch.core.workflow import run_train

    iid = run_train(factory, variant=variant, batch=args.batch,
                    verbose=args.verbose, device=args.device,
                    resume=args.resume,
                    scan_cache=False if args.no_scan_cache else None,
                    use_mesh=not args.no_mesh)
    print(f"[info] Training completed: engine instance {iid} "
          f"(kernel launches: {_launch_counts()})")


def _read_through_view() -> None:
    """Read an EVENTLOG home through a private view of its log
    (``data/replication.LogView``): an event server may be writing it,
    and the native engine neither sees another process's appends after
    it opens a file nor may open a file that is being written."""
    from predictionio_tpu_torch.storage.registry import (
        Storage,
        StorageConfig,
        set_storage,
    )

    config = StorageConfig.from_env()
    if config.eventdata_type == "EVENTLOG":
        from predictionio_tpu_torch.data.replication import LogView

        set_storage(Storage(config, events=LogView(config.home)))


def _run_continuous(args: argparse.Namespace, variant: Dict[str, Any],
                    factory: str) -> None:
    """The supervised continuous-training loop (``train --continuous``):
    lease, watermark wake, resumable delta train on ``--device``,
    registry candidate, gate, promote and ``/reload`` push, bake window
    with automatic rollback (``server/trainer.py``)."""
    from predictionio_tpu_torch.server.trainer import (
        ContinuousTrainer,
        TrainerConfig,
    )

    dsp = (variant.get("datasource") or {}).get("params") or {}
    app_name = args.app or dsp.get("app_name") or dsp.get("appName")
    if not app_name:
        _die("--continuous needs --app or an appName in the variant's "
             "datasource params")
    cfg = TrainerConfig(
        engine_factory=factory,
        app_name=app_name,
        variant=variant,
        variant_id=str(variant.get("id", "")),
        channel=args.channel,
        min_delta_events=args.min_delta_events,
        poll_interval=args.poll_interval,
        lease_ttl=args.lease_ttl,
        retain=args.retain,
        guardrail_holdout=args.guardrail_holdout,
        guardrail_max_regress=args.guardrail_max_regress,
        guardrail_min_events=args.guardrail_min_events,
        gate=args.gate,
        eval_leaderboard_max_age=args.eval_leaderboard_max_age,
        online_champion=args.online_champion,
        online_challenger=args.online_challenger,
        online_min_pairs=args.online_min_pairs,
        online_max_regress=args.online_max_regress,
        bake_seconds=args.bake_seconds,
        bake_error_rate=args.bake_error_rate,
        bake_p95_ratio=args.bake_p95_ratio,
        reload_urls=args.reload_url or [],
        router_url=args.router_url,
        fleet_manifest=args.fleet_manifest,
        use_mesh=not args.no_mesh,
        device=args.device,
        verbose=args.verbose,
        metrics_port=args.metrics_port,
        incident_dir=_incident_dir(args),
    )
    trainer = ContinuousTrainer(cfg)
    print(f"[info] Continuous trainer: app={app_name!r} "
          f"min_delta={cfg.min_delta_events} lease={trainer.lease.path}",
          flush=True)
    outcomes = trainer.run(max_cycles=args.max_cycles)
    for rec in outcomes[-10:]:
        print(f"[train] {rec['outcome']}"
              + (f" gen={rec['generation']}" if rec["generation"] else ""))
    print(f"[info] Continuous trainer stopped after {len(outcomes)} cycles.")


def _launch_counts() -> str:
    from predictionio_tpu_torch import ops

    return ", ".join(f"{c.__name__}={c.launches}" for c in ops.LAUNCH_COUNTERS)


def cmd_deploy(args: argparse.Namespace) -> None:
    _configure_tracing(args)
    _stop_on_sigterm()
    server = make_server(args)
    device = server.deployed.algorithms[0][1].device
    if args.variants:
        snap = server._mux.snapshot()
        arms = ", ".join(
            f"{n}=gen-{v['generation']:06d}" if v["generation"] is not None
            else f"{n}={v['state']}"
            for n, v in snap["variants"].items())
        print(f"[info] Engine Server ({arms}, device {device}) "
              f"listening on {args.ip}:{args.port}")
    else:
        print(f"[info] Engine Server (instance {server.deployed.instance.id}, "
              f"device {device}) listening on {args.ip}:{args.port}", flush=True)
    try:
        server.run()
    except KeyboardInterrupt:
        pass  # SIGINT, or SIGTERM from a supervisor: a stop
    finally:
        # what the server launched on the card, read when it stops
        # (`GET /stop`, SIGINT or SIGTERM)
        print(f"[info] kernel launches: {_launch_counts()}", flush=True)


def cmd_batchpredict(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.core.batchpredict import run_batch_predict
    from predictionio_tpu_torch.core.workflow import prepare_deploy

    variant = _load_variant_file(args.engine_dir, args.variant)
    factory = variant.get("engineFactory") or _die("engine.json missing engineFactory")
    deployed = prepare_deploy(engine_factory=factory,
                              instance_id=args.engine_instance_id,
                              variant_id=str(variant.get("id", "")),
                              device=args.device)
    with open(args.input, "r", encoding="utf-8") as src, \
         open(args.output, "w", encoding="utf-8") as out:
        n = run_batch_predict(deployed, src, out, batch_size=args.batch_size,
                              shards=args.shards)
    print(f"[info] Batch predicted {n} queries → {args.output}")
    print(f"[info] kernel launches: {_launch_counts()}")


# -- eval, evals ------------------------------------------------------------


def _print_leaderboard(doc: dict, as_json: bool) -> None:
    from predictionio_tpu_torch.storage import leaderboard as lb

    if as_json:
        print(json.dumps(doc, indent=2))
        return
    print(f"[leaderboard] instance={doc.get('instanceId')} "
          f"metric={doc.get('metric')} mode={doc.get('mode')} "
          f"grid={doc.get('gridSize')} digest={lb.digest(doc)}")
    if doc.get("mode") == "distributed":
        print(f"[leaderboard] buckets={doc.get('buckets')} "
              f"compiles={doc.get('compiles')} "
              f"dispatches={doc.get('dispatches')} "
              f"shards={doc.get('shards')} "
              f"wall={doc.get('wallSeconds', 0):.3f}s "
              f"device={doc.get('deviceSeconds', 0):.3f}s")
    for e in doc.get("entries", []):
        score = e.get("score")
        folds = e.get("foldScores") or []
        fold_s = (" folds=[" + ", ".join(
            "nan" if s is None else f"{s:.4f}" for s in folds) + "]"
            if folds else "")
        algos = (e.get("engineParams") or {}).get("algorithmsParams") or []
        algo_s = "; ".join(
            f"{a.get('name')}:{json.dumps(a.get('params'), sort_keys=True, default=str)}"
            for a in algos)
        print(f"  #{e['rank']:<3} cand {e['index']:<3} "
              f"score={'nan' if score is None else f'{score:.6f}'}"
              f"{fold_s}  {algo_s}")


def _eval_leaderboard(args: argparse.Namespace) -> None:
    """`eval leaderboard [instance_id]`: a persisted sweep leaderboard,
    read from JSON alone (no torch, no engine code)."""
    from predictionio_tpu_torch.storage import leaderboard as lb

    home = get_storage().config.home
    iid = args.engine_params_generator  # optional positional, reused
    doc = lb.read(home, iid) if iid else lb.latest(home)
    if doc is None:
        _die("no leaderboard found"
             + (f" for instance {iid}" if iid else
                f" under {lb.leaderboard_dir(home)}; run `pio eval "
                "--distributed` (or any eval) first"))
    _print_leaderboard(doc, args.json)


def cmd_eval(args: argparse.Namespace) -> None:
    if args.evaluation == "leaderboard":
        _eval_leaderboard(args)
        return
    from predictionio_tpu_torch.core.workflow import run_evaluation
    from predictionio_tpu_torch.storage import leaderboard as lb
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.utils.imports import resolve_spec

    if not args.engine_params_generator:
        _die("pio eval needs an engine params generator (module:attr)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        _die(str(e))
    sys.path.insert(0, os.path.abspath(args.engine_dir))
    ev_obj = resolve_spec(args.evaluation)
    evaluation = ev_obj() if isinstance(ev_obj, type) else ev_obj
    gen_obj = resolve_spec(args.engine_params_generator)
    generator = gen_obj() if isinstance(gen_obj, type) else gen_obj
    instance_id, result = run_evaluation(
        evaluation, generator.engine_params_list,
        verbose=args.verbose,
        evaluation_class=args.evaluation,
        generator_class=args.engine_params_generator,
        distributed=args.distributed,
        sweep_shards=args.sweep_shards,
        device=device,
    )
    print(f"[info] Evaluation completed: instance {instance_id}")
    metric = evaluation.metric
    for i, (_, score, _) in enumerate(result.candidates):
        mark = " *best*" if i == result.best_index else ""
        print(f"  candidate {i}: {metric.header} = {score:.6f}{mark}")
    doc = lb.read(get_storage().config.home, instance_id)
    if doc is not None:
        _print_leaderboard(doc, args.json)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(result.to_json())
        print(f"[info] wrote {args.output}")


def cmd_evals(args: argparse.Namespace) -> None:
    """Evaluation-instance inspection from SQLite and JSON alone (no
    torch): list past grid searches, explain a dead one (the FAILED row
    carries the exception), show leaderboards."""
    from predictionio_tpu_torch.storage import leaderboard as lb

    st = get_storage()
    home = st.config.home
    if args.evals_cmd == "list":
        rows = []
        for vi in st.meta.list_evaluation_instances():
            rows.append({
                "id": vi.id,
                "status": vi.status,
                "evaluationClass": vi.evaluation_class,
                "startTime": str(vi.start_time) if vi.start_time else None,
                "endTime": str(vi.end_time) if vi.end_time else None,
                "results": vi.evaluator_results or "",
                "hasLeaderboard": os.path.exists(
                    lb.leaderboard_path(home, vi.id)),
            })
        if args.json:
            print(json.dumps({"evaluations": rows}, indent=2))
            return
        if not rows:
            print("[evals] no evaluation instances")
            return
        for r in rows:
            mark = " +leaderboard" if r["hasLeaderboard"] else ""
            print(f"  {r['id']}  {r['status']:<14} "
                  f"{r['evaluationClass']:<24} {r['results']}{mark}")
        return
    vi = st.meta.get_evaluation_instance(args.instance_id)
    if vi is None:
        _die(f"no evaluation instance {args.instance_id!r}")
    doc = {
        "id": vi.id,
        "status": vi.status,
        "evaluationClass": vi.evaluation_class,
        "generatorClass": vi.engine_params_generator_class,
        "startTime": str(vi.start_time) if vi.start_time else None,
        "endTime": str(vi.end_time) if vi.end_time else None,
        # EVALCOMPLETED: the best-candidate summary. FAILED: the
        # recorded exception type and message
        "results": vi.evaluator_results or "",
        "resultsJson": (json.loads(vi.evaluator_results_json)
                        if vi.evaluator_results_json else None),
        "leaderboard": lb.read(home, vi.id),
    }
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
        return
    print(f"[evals] {doc['id']}  status={doc['status']}")
    print(f"[evals] class={doc['evaluationClass']} "
          f"generator={doc['generatorClass'] or '-'}")
    print(f"[evals] start={doc['startTime']} end={doc['endTime']}")
    if doc["results"]:
        print(f"[evals] results: {doc['results']}")
    if doc["leaderboard"] is not None:
        _print_leaderboard(doc["leaderboard"], False)


# -- export, import, status -------------------------------------------------


# -- index --------------------------------------------------------------------


def _human_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024
    raise AssertionError


def cmd_index(args: argparse.Namespace) -> None:
    """ANN retrieval-index status for the deployed (latest COMPLETED)
    engine instance: geometry, sizes, HBM estimate, build time, digest
    verdict. Reads only the on-disk artifact manifest + sidecar
    (torch-free — this verb must work on an ops box with no accelerator
    stack), so a memory-backed model store has nothing to show. Prints
    the JAX CLI's text and JSON."""
    from datetime import datetime, timezone

    from predictionio_tpu_torch.ann.index import (
        INDEX_BASENAME, MANIFEST_BASENAME, shard_view)
    from predictionio_tpu_torch.utils.integrity import DIGEST_SUFFIX, sha256_hex

    st = get_storage()
    iid = args.engine_instance_id
    if not iid:
        latest = next((ei for ei in st.meta.list_engine_instances()
                       if ei.status == "COMPLETED"), None)
        if latest is None:
            _die("no COMPLETED engine instance found "
                 "(train one, or pass --engine-instance-id)")
        iid = latest.id
    instance_dir = st.models.model_dir(iid)
    if instance_dir is None:
        _die(f"model store {type(st.models).__name__} has no filesystem "
             "directory — ANN index manifests live beside model.bin "
             "(LOCALFS)")
    found = []
    for algo in sorted(os.listdir(instance_dir)):
        algo_dir = os.path.join(instance_dir, algo)
        man_path = os.path.join(algo_dir, MANIFEST_BASENAME)
        if not os.path.isfile(man_path):
            continue
        try:
            with open(man_path, "r", encoding="utf-8") as f:
                man = json.load(f)
        except (OSError, ValueError) as e:
            found.append({"algorithm": algo, "digest_status": "corrupt",
                          "detail": f"unreadable manifest: {e}"})
            continue
        blob_path = os.path.join(algo_dir, INDEX_BASENAME)
        digest_status = "missing-blob"
        if os.path.exists(blob_path):
            with open(blob_path, "rb") as f:
                actual = sha256_hex(f.read())
            side = None
            try:
                with open(blob_path + DIGEST_SUFFIX, "r",
                          encoding="ascii") as f:
                    side = f.read().strip()
            except OSError:
                pass
            if actual == man.get("sha256") and (side is None
                                                or side == actual):
                digest_status = ("verified" if side is not None
                                 else "unchecksummed")
            else:
                digest_status = "MISMATCH"
        entry = {"algorithm": algo, "digest_status": digest_status,
                 **{k: man.get(k) for k in (
                     "m", "k", "dsub", "dim", "n_items", "code_bytes",
                     "codebook_bytes", "rotation_bytes",
                     "hbm_estimate_bytes", "shards",
                     "build_sec", "built_unix", "sha256")}}
        # per-shard layout math from the manifest alone (the index
        # module is numpy only — safe on an ops box): size a candidate
        # serving mesh before any deploy touches a card
        want_shards = int(getattr(args, "shards", 0) or 0) \
            or int(man.get("shards") or 0)
        if want_shards > 1 and man.get("n_items") is not None:
            entry["shard_view"] = shard_view(man, want_shards)
        found.append(entry)
    doc = {"engineInstanceId": iid, "instanceDir": instance_dir,
           "indexes": found}
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return
    print(f"[index] engine instance {iid}")
    if not found:
        print("[index] no ANN index artifacts (exact retrieval; enable "
              "with \"ann\": true in engine.json algorithm params)")
        return
    for ix in found:
        print(f"[index] algorithm {ix['algorithm']!r}: "
              f"status={ix['digest_status']}")
        if ix.get("detail"):
            print(f"        {ix['detail']}")
            continue
        if ix.get("m") is None:
            continue
        print(f"        geometry   M={ix['m']} K={ix['k']} "
              f"dsub={ix['dsub']} (dim {ix['dim']})")
        print(f"        corpus     {ix['n_items']:,} items, "
              f"codes {_human_bytes(ix['code_bytes'])}, "
              f"codebooks {_human_bytes(ix['codebook_bytes'])}")
        print(f"        HBM est.   {_human_bytes(ix['hbm_estimate_bytes'])} "
              "(codes + codebooks + re-rank floats)")
        sv = ix.get("shard_view")
        if sv:
            print(f"        sharded    {sv['shards']}-way mesh: "
                  f"{sv['rows_per_shard']:,} rows/device "
                  f"({sv['padded_items'] - ix['n_items']} pad), "
                  f"codes {_human_bytes(sv['code_bytes_per_shard'])}/dev, "
                  f"rerank {_human_bytes(sv['rerank_bytes_per_shard'])}/dev")
            print(f"        HBM/device {_human_bytes(sv['hbm_per_device_bytes'])} "
                  f"(+ {_human_bytes(sv['replicated_bytes'])} replicated "
                  "codebooks/rotation)")
        built = ix.get("built_unix")
        when = (datetime.fromtimestamp(built, timezone.utc)
                .strftime("%Y-%m-%d %H:%M:%SZ") if built else "?")
        print(f"        built      {when} in {ix.get('build_sec', '?')}s, "
              f"sha256 {str(ix.get('sha256'))[:12]}…")



# -- models, variants, incidents ---------------------------------------------


def _http_json(url: str, *, method: str = "GET",
               body: Optional[dict] = None, timeout: float = 10.0) -> dict:
    """GET/POST JSON over urllib (torch-free ops path). An HTTP error
    with a JSON body comes back as that body plus ``_status``, so
    callers can show the replica's own refusal reason instead of a
    stack trace; transport errors still raise."""
    import urllib.error
    import urllib.request

    data = None
    headers = {}
    if body is not None:
        data = json.dumps(body).encode("utf-8")
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            doc = json.loads(e.read() or b"{}")
        except ValueError:
            doc = {}
        doc["_status"] = e.code
        return doc


def _replica_urls(args: argparse.Namespace) -> List[str]:
    """--url (repeatable) plus manifest lines (router format: first
    token is the URL, ``variants=`` annotations ignored here)."""
    urls = list(args.url or [])
    if getattr(args, "manifest", None):
        try:
            with open(args.manifest, "r", encoding="utf-8") as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln or ln.startswith("#"):
                        continue
                    u = ln.split()[0]
                    urls.append(u if "//" in u else "http://" + u)
        except OSError as e:
            _die(f"cannot read manifest {args.manifest!r}: {e}")
    return urls


def cmd_variants(args: argparse.Namespace) -> None:
    """Operate the live variant split (torch-free: runs on an ops box).
    ``status`` shows each replica's resident arms with warmup state and
    online score; ``set-weights`` re-splits traffic fleet-wide with
    probe-then-apply semantics: every replica must report every named
    arm serving BEFORE any replica's weights change, so a typo'd arm or
    a half-warmed challenger can't blackhole traffic on part of the
    fleet."""
    urls = _replica_urls(args)
    if not urls:
        _die("no replicas: pass --url (repeatable) or --manifest FILE")
    if args.variants_cmd == "status":
        out = {}
        for u in urls:
            base = u.rstrip("/")
            try:
                out[base] = _http_json(f"{base}/variants",
                                       timeout=args.timeout)
            except Exception as e:  # noqa: BLE001 — per-replica verdict
                out[base] = {"error": f"{type(e).__name__}: {e}"}
        if args.json:
            print(json.dumps(out, indent=2, sort_keys=True))
            return
        for base, doc in out.items():
            if "variants" not in doc:
                why = doc.get("error") or f"HTTP {doc.get('_status')}"
                print(f"[variants] {base}: {why}")
                continue
            print(f"[variants] {base} default={doc['default']} "
                  f"salt={doc['salt']!r} epoch={doc['weightsEpoch']}")
            for name, arm in sorted(doc["variants"].items()):
                gen = arm.get("generation")
                on = arm.get("online") or {}
                rmse = on.get("onlineRmse")
                print(f"  {name:<16} "
                      f"gen={'?' if gen is None else gen}  "
                      f"state={arm['state']:<8} "
                      f"w={arm['weight']:g}"
                      f"→{arm['effectiveWeight']:.3f}  "
                      f"served={on.get('served', 0)} "
                      f"ctr={on.get('ctr', 0.0):.3f} "
                      f"rmse={'-' if rmse is None else f'{rmse:.4f}'}")
        return
    # set-weights: probe ALL replicas before writing ANY
    from predictionio_tpu_torch.server.variants import parse_weights

    try:
        specs = parse_weights(args.weights)
    except ValueError as e:
        _die(str(e))
    if any(s.gen is not None for s in specs):
        _die("set-weights re-splits arms already resident — generation "
             "pins (name@N) belong to `pio deploy --variants`")
    weights = {s.name: s.weight for s in specs}
    probed: List[str] = []
    for u in urls:
        base = u.rstrip("/")
        try:
            doc = _http_json(f"{base}/variants", timeout=args.timeout)
        except Exception as e:  # noqa: BLE001
            _die(f"probe {base}/variants failed: {type(e).__name__}: {e} "
                 "(no weights were changed)")
        arms = doc.get("variants") or {}
        missing = sorted(n for n in weights
                         if (arms.get(n) or {}).get("state") != "ready")
        if missing:
            _die(f"{base}: arm(s) not serving: {', '.join(missing)} "
                 "(no weights were changed)")
        probed.append(base)
    failed = False
    for base in probed:
        doc = _http_json(f"{base}/variants/weights", method="POST",
                         body={"weights": weights}, timeout=args.timeout)
        if "_status" in doc:
            print(f"[variants] {base}: refused "
                  f"({doc.get('error') or doc['_status']})")
            failed = True
        else:
            print(f"[variants] {base}: weights applied "
                  f"(epoch {doc.get('weightsEpoch')})")
    if failed:
        raise SystemExit(1)


def cmd_models(args: argparse.Namespace) -> None:
    """Generation-aware model registry verbs. Operator writes carry no
    fencing token (``token=None`` bypasses the fence deliberately — the
    human outranks a wedged trainer); meta statuses are re-synced so a
    plain ``/reload`` lands on the chosen champion."""
    from predictionio_tpu_torch.storage.models import model_registry

    st = get_storage()
    reg = model_registry(st)
    if args.models_cmd == "list":
        doc = {"championGeneration": (reg.champion() or {}).get("gen"),
               "fenceToken": reg.fence_token(),
               "generations": reg.generations()}
        if args.replica_url:
            # residency column: which generations each serving replica
            # actually holds in HBM right now (reads /health, so a
            # not-ready 503 still yields the variants block)
            doc["variants"] = {}
            for u in args.replica_url:
                base = u.rstrip("/")
                try:
                    h = _http_json(f"{base}/health", timeout=5.0)
                    doc["variants"][base] = h.get("variants") or {}
                except Exception as e:  # noqa: BLE001
                    doc["variants"][base] = {
                        "error": f"{type(e).__name__}: {e}"}
        if args.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
            return
        champ = doc["championGeneration"]
        print(f"[models] champion=gen-{champ:06d}" if champ is not None
              else "[models] champion=(none)")
        print(f"[models] fence token={doc['fenceToken']}")
        for e in doc["generations"]:
            mark = " *champion*" if e["gen"] == champ else ""
            print(f"  gen-{e['gen']:06d}  {e['status']:<12} "
                  f"instance={e['instance_id']}  "
                  f"sha256={e['sha256'][:12]}…{mark}")
        for base, snap in (doc.get("variants") or {}).items():
            arms = snap.get("variants") if isinstance(snap, dict) else None
            if not arms:
                why = (snap.get("error") or "no variant set resident"
                       if isinstance(snap, dict) else snap)
                print(f"  replica {base}: {why}")
                continue
            residency = ", ".join(
                (f"{n}=gen-{a['generation']:06d}[{a['state']}]"
                 if a.get("generation") is not None
                 else f"{n}=?[{a['state']}]")
                for n, a in sorted(arms.items()))
            print(f"  replica {base}: {residency}")
        return
    if args.models_cmd == "promote":
        try:
            entry = reg.promote(args.generation)
        except KeyError as e:
            _die(str(e))
        reg.sync_meta(st.meta)
        print(f"[models] promoted gen-{entry['gen']:06d} "
              f"(instance {entry['instance_id']}). "
              "GET /reload on each replica (or `pio router reload "
              "--rolling`) to swap serving onto it.")
        return
    if args.models_cmd == "rollback":
        try:
            entry = reg.rollback()
        except LookupError as e:
            _die(str(e))
        reg.sync_meta(st.meta)
        print(f"[models] rolled back to gen-{entry['gen']:06d} "
              f"(instance {entry['instance_id']}). "
              "GET /reload on each replica (or `pio router reload "
              "--rolling`) to swap serving onto it.")





def cmd_incidents(args: argparse.Namespace) -> None:
    """Browse the incident flight recorder's bundles (torch-free: runs
    on an ops box against a copied store just as well)."""
    from predictionio_tpu_torch.storage.registry import StorageConfig
    from predictionio_tpu_torch.utils import incidents as incmod

    root = args.dir or incmod.default_incident_dir(
        StorageConfig.from_env().home)
    store = incmod.IncidentStore(root)
    if args.inc_cmd == "list":
        rows = store.list_bundles()
        if args.json:
            print(json.dumps(rows, indent=2, sort_keys=True))
            return
        if not rows:
            print(f"[info] no incident bundles under {root}")
            return
        print(f"{'ID':<38}{'PROC':<9}{'TRIGGERS':<28}SLOS / ARMED FAULTS")
        for r in rows:
            if r.get("incomplete"):
                print(f"{r['id']:<38}{'?':<9}(incomplete: no manifest)")
                continue
            trig = ",".join(r.get("triggers") or [r.get("trigger") or "?"])
            tail = "  ".join((r.get("sloFastBurning") or [])
                             + [f"fault:{s}" for s in r.get("faults") or []])
            print(f"{r['id']:<38}{r.get('process') or '?':<9}"
                  f"{trig:<28}{tail}")
        return
    if args.inc_cmd == "show":
        iid = args.id or (store.ids() or [None])[0]
        if not iid:
            _die(f"no incident bundles under {root}")
        bundle = store.load_bundle(iid)
        if bundle is None:
            _die(f"incident {iid!r} not found (or incomplete) under {root}")
        if args.json:
            print(json.dumps(bundle, indent=2, sort_keys=True))
            return
        m = bundle["manifest"]
        print(f"incident {iid}  process={m.get('process')}  "
              f"at={m.get('capturedAt')}")
        for t in m.get("triggers", []):
            print(f"  trigger {t.get('trigger')}  "
                  f"detail={json.dumps(t.get('detail') or {}, sort_keys=True)}")
        if m.get("sloFastBurning"):
            print(f"  fast-burning SLOs: {', '.join(m['sloFastBurning'])}")
        if m.get("faults"):
            print(f"  armed fault sites: {', '.join(sorted(m['faults']))}")
        ex = m.get("exemplars") or []
        if ex:
            print(f"  pinned exemplars: {len(ex)} "
                  f"(worst {ex[0].get('valueMs')}ms in "
                  f"{ex[0].get('series')}, trace {ex[0].get('traceId')})")
        print(f"  files: {', '.join(m.get('files', []))}")
        return
    removed = store.prune(args.retain)
    print(f"[info] removed {len(removed)} bundle(s); "
          f"{len(store.ids())} retained under {root}")


def cmd_doctor(args: argparse.Namespace) -> None:
    """Ranked findings from a captured incident bundle or the live fleet
    (torch-free). Exit 0 = clean, 1 = warnings, 2 = firing evidence."""
    from predictionio_tpu_torch.utils import incidents as incmod

    if args.incident:
        from predictionio_tpu_torch.storage.registry import StorageConfig

        root = args.dir or incmod.default_incident_dir(
            StorageConfig.from_env().home)
        store = incmod.IncidentStore(root)
        iid = args.incident
        if iid == "latest":
            ids = store.ids()
            if not ids:
                _die(f"no incident bundles under {root}")
            iid = ids[0]
        bundle = store.load_bundle(iid)
        if bundle is None:
            _die(f"incident {iid!r} not found (or incomplete) under {root}")
        findings = incmod.diagnose(bundle)
        header = (f"doctor — incident {iid} "
                  f"(process={bundle['manifest'].get('process')})")
    else:
        base = args.url.rstrip("/")
        try:
            slo_doc = _http_json(f"{base}/slo/status", timeout=args.timeout)
            health_doc = _http_json(f"{base}/health", timeout=args.timeout)
            top_doc = _http_json(f"{base}/top?window=5m",
                                 timeout=args.timeout)
        except Exception as e:  # noqa: BLE001 — ops verb, readable failure
            _die(f"live diagnosis against {base} failed: "
                 f"{type(e).__name__}: {e}")
        findings = incmod.diagnose_live(slo_doc, health_doc, top_doc)
        header = f"doctor — live fleet at {base}"
    code = incmod.exit_code(findings)
    results = None
    if args.act:
        # findings onto conf/remediations.json playbooks; without --yes
        # a dry run: the plan prints, nothing executes
        from predictionio_tpu_torch.server.remediate import (
            OpsActuator,
            RemediationEngine,
            load_playbooks,
        )
        from predictionio_tpu_torch.storage.registry import StorageConfig

        home = StorageConfig.from_env().home
        engine = RemediationEngine(
            OpsActuator(url=None if args.incident else args.url,
                        home=home, timeout=args.timeout),
            load_playbooks(args.remediations),
            lock_path=os.path.join(home, "remediation.lock"))
        results = engine.execute(engine.plan(findings), yes=args.yes)
    if args.json:
        out = {"findings": findings, "exit": code}
        if results is not None:
            out["remediation"] = results
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(header)
        if not findings:
            print("  no findings — clean bill of health")
        labels = {2: "FIRING", 1: "warn", 0: "info"}
        for f in findings:
            print(f"  [{labels[f['severity']]:<6}] {f['title']}")
            print(f"           {f['evidence']}")
        if results is not None:
            mode = ("EXECUTED" if args.yes else
                    "DRY RUN — pass --yes to execute")
            print(f"remediation plan ({mode}):")
            if not results:
                print("  nothing to do — no finding matches a playbook")
            for r in results:
                print(f"  [{r['result']:<11}] {r['playbook']}: "
                      f"{r['action']} -> {r['target']}")
                if r.get("detail"):
                    print(f"               {r['detail']}")
    raise SystemExit(code)


# -- the fleet router and its control plane -----------------------------------


def _stop_on_sigterm() -> None:
    """Turn SIGTERM into the SIGINT stop (``KeyboardInterrupt``), so a
    supervised server runs its ``finally`` (a pool's replicas stopped,
    the launch counts printed) when its supervisor stops it."""
    import signal

    def on_term(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread: the caller stops the server itself


def cmd_router(args: argparse.Namespace) -> None:
    """Fleet router: one endpoint over N engine-server replicas (P2C
    routing, retry budget, hedging, rolling reload;
    ``server/router.py``)."""
    if args.router_cmd == "serve":
        from predictionio_tpu_torch.server.router import FleetRouter

        _configure_tracing(args)
        replicas = ([u for u in args.replicas.split(",") if u.strip()]
                    if args.replicas else None)
        pool = None
        autoscale_cfg = None
        if args.pool_spawn and not args.manifest:
            _die("--pool-spawn needs --manifest (the file the pool "
                 "rewrites and the router watches)")
        _stop_on_sigterm()
        try:
            if args.pool_spawn:
                import shlex

                from predictionio_tpu_torch.tools.supervise import (
                    ReplicaPool,
                    normalize_command,
                )

                pool = ReplicaPool(normalize_command(shlex.split(args.pool_spawn)),
                                   args.manifest)
                for _ in range(max(1, args.min_replicas)):
                    name = pool.add_replica()
                    print(f"[info] pool replica {name} ready", flush=True)
                if not args.no_autoscale:
                    from predictionio_tpu_torch.server.autoscale import (
                        AutoscaleConfig,
                    )

                    autoscale_cfg = AutoscaleConfig(
                        min_replicas=max(1, args.min_replicas),
                        max_replicas=max(1, args.max_replicas),
                        interval=args.autoscale_interval)
            router = FleetRouter(
                replicas=replicas,
                manifest=args.manifest,
                host=args.ip, port=args.port,
                health_interval=args.health_interval,
                retry_budget_ratio=args.retry_budget,
                hedge=not args.no_hedge,
                hedge_min_ms=args.hedge_min_ms,
                default_deadline_ms=args.deadline_ms,
                per_try_timeout_ms=args.per_try_timeout_ms,
                drain_timeout=args.drain_timeout,
                ready_timeout=args.ready_timeout,
                access_log=args.access_log,
                tenant_quotas=args.tenant_quotas,
                slo_config=args.slo_config,
                scrape_interval=args.scrape_interval,
                probe_interval=args.probe_interval,
                incident_dir=_incident_dir(args),
                pool=pool,
                autoscale=autoscale_cfg,
                remediations=args.remediations,
            )
            print(f"[info] Fleet router on {args.ip}:{args.port} over "
                  f"{len(router.replicas)} replicas "
                  f"({', '.join(r.name for r in router.replicas)})", flush=True)
            if autoscale_cfg is not None:
                print(f"[info] autoscaler on: {autoscale_cfg.min_replicas}"
                      f"-{autoscale_cfg.max_replicas} replicas, tick every "
                      f"{autoscale_cfg.interval:g}s (--no-autoscale to "
                      "disable)", flush=True)
            router.run()
        except KeyboardInterrupt:
            pass
        finally:
            if pool is not None:
                pool.stop_all()
        return

    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")
    if args.router_cmd == "status":
        with urllib.request.urlopen(f"{base}/router/status",
                                    timeout=args.timeout) as r:
            print(json.dumps(json.loads(r.read()), indent=2, sort_keys=True))
        return
    # reload: POST /router/reload[?rolling=1], with a long timeout: a
    # rolling pass drains and re-warms every replica in turn
    qs = "?rolling=1" if args.rolling else ""
    req = urllib.request.Request(f"{base}/router/reload{qs}", data=b"",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        out = json.loads(e.read() or b"{}")
    print(json.dumps(out, indent=2, sort_keys=True))
    if not out.get("ok"):
        _die("fleet reload failed")


def cmd_slo(args: argparse.Namespace) -> None:
    """SLO burn-rate status from a running router (torch-free). Exit 1
    while any SLO is fast-burning."""
    base = args.url.rstrip("/")
    try:
        doc = _http_json(f"{base}/slo/status", timeout=args.timeout)
    except Exception as e:  # noqa: BLE001 — ops verb, readable failure
        _die(f"GET {base}/slo/status failed: {type(e).__name__}: {e}")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        windows = (doc.get("windows") or {})
        th = (doc.get("thresholds") or {})
        print(f"[slo] {base}  fast windows "
              f"{'/'.join(windows.get('fast', []))} > {th.get('fast')}  "
              f"slow {'/'.join(windows.get('slow', []))} > {th.get('slow')}")
        labels = {0: "ok", 1: "SLOW BURN", 2: "FAST BURN"}
        for s in doc.get("slos", []):
            burns = "  ".join(f"{w}={b:g}" for w, b in
                              sorted((s.get("burnRate") or {}).items()))
            print(f"  {s['name']:<24} objective={s['objective']:g}  "
                  f"{burns}  {labels.get(s.get('alerting'), '?')}")
    if doc.get("fastBurning"):
        raise SystemExit(1)


def cmd_top(args: argparse.Namespace) -> None:
    """Terminal fleet view over the router's federated history
    (torch-free): a refresh loop over ``GET /top``, which computes
    everything shown."""
    import time

    base = args.url.rstrip("/")
    watch = getattr(args, "watch", 0.0) or 0.0
    once = (args.once or args.json) and not watch
    interval = watch or args.interval

    def frame() -> None:
        doc = _http_json(f"{base}/top?window={args.window}",
                         timeout=args.timeout)
        if args.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
            return
        if "_status" in doc:
            print(f"[top] {base}: HTTP {doc['_status']}: "
                  f"{doc.get('message')}")
            return
        if not once:
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
        qps = doc.get("qps") or {}
        by = ", ".join(f"{k}:{v:g}" for k, v in
                       sorted((qps.get("byStatus") or {}).items()))
        print(f"pio top — {base}  window={doc.get('windowSeconds'):g}s")
        print(f"qps {qps.get('total', 0):g}" + (f"  ({by})" if by else ""))
        paths = doc.get("paths") or {}
        if paths:
            print(f"{'PATH':<16}{'QPS':>8}{'P50MS':>10}{'P99MS':>10}")
            for p, row in sorted(paths.items()):
                p50, p99 = row.get("p50Ms"), row.get("p99Ms")
                print(f"{p:<16}{row.get('qps', 0):>8g}"
                      f"{'-' if p50 is None else p50:>10}"
                      f"{'-' if p99 is None else p99:>10}")
        variants = doc.get("variants") or {}
        if variants:
            print(f"{'VARIANT':<16}{'QPS':>8}{'SHARE':>10}")
            for v, row in sorted(variants.items()):
                print(f"{v:<16}{row.get('qps', 0):>8g}"
                      f"{row.get('share', 0) * 100:>9.1f}%")
        sheds = doc.get("tenantSheds") or {}
        if sheds:
            print("sheds/s  " + "  ".join(
                f"{a}={r:g}" for a, r in sorted(sheds.items())))
        probe = doc.get("probe") or {}
        if probe:
            print("probe/s  " + "  ".join(
                f"{o}={r:g}" for o, r in sorted(probe.items())))
        slo = doc.get("slo") or {}
        labels = {0: "ok", 1: "SLOW", 2: "FAST-BURN"}
        for s in slo.get("slos", []):
            burns = "  ".join(f"{w}={b:g}" for w, b in
                              sorted((s.get("burnRate") or {}).items()))
            print(f"slo {s['name']:<22} {burns}  "
                  f"{labels.get(s.get('alerting'), '?')}")
        print(f"{'REPLICA':<22}{'STATE':<11}{'BREAKER':<9}"
              f"{'EWMA-MS':>8}  GEN")
        for r in doc.get("replicas", []):
            gen = r.get("modelGeneration")
            print(f"{r.get('url', '?'):<22}{r.get('state', '?'):<11}"
                  f"{r.get('breaker', '?'):<9}{r.get('ewmaMs', 0):>8g}"
                  f"  {'-' if gen is None else gen}")

    try:
        frame()
        while not once:
            time.sleep(max(0.2, interval))
            frame()
    except KeyboardInterrupt:
        pass
    except Exception as e:  # noqa: BLE001 — ops verb, readable failure
        _die(f"GET {base}/top failed: {type(e).__name__}: {e}")


def cmd_undeploy(args: argparse.Namespace) -> None:
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    with urllib.request.urlopen(url, timeout=10) as r:
        print(r.read().decode())


def cmd_template(args: argparse.Namespace) -> None:
    """``template list`` prints the registry; ``template new NAME DIR``
    copies the template's ``engine.json`` into DIR (a template without
    one gets a minimal variant naming its factory)."""
    import importlib
    import shutil

    from predictionio_tpu_torch.templates import TEMPLATES

    if args.tpl_cmd == "list":
        for name, mod in TEMPLATES.items():
            print(f"{name:<26} {mod}")
        return
    name, dest = args.name, args.dir
    if name not in TEMPLATES:
        _die(f"unknown template {name!r}; see `pio template list`")
    try:
        mod = importlib.import_module(TEMPLATES[name])
    except ImportError as e:
        _die(f"template {name!r} is not available: {e}")
    os.makedirs(dest, exist_ok=True)
    src = os.path.join(os.path.dirname(mod.__file__), "engine.json")
    dst = os.path.join(dest, "engine.json")
    if os.path.exists(src):
        shutil.copyfile(src, dst)
    else:
        with open(dst, "w", encoding="utf-8") as f:
            json.dump({"id": "default",
                       "engineFactory": TEMPLATES[name] + ":engine_factory"},
                      f, indent=2)
    print(f"[info] Created engine dir {dest} from template {name!r}. "
          f"Edit {dst} (set appName) and run `pio train`.")


def cmd_build(args: argparse.Namespace) -> None:
    """Validate an engine dir: engine.json parses, the factory resolves
    to one of the port's templates, the params bind. Python needs no
    compile step, so build is the static check before ``train``."""
    variant = _load_variant_file(args.engine_dir, args.variant)
    factory = variant.get("engineFactory") or _die("engine.json missing engineFactory")
    from predictionio_tpu_torch.controller.engine import EngineFactory
    from predictionio_tpu_torch.core.workflow import port_factory

    try:
        EngineFactory.create(port_factory(factory)).params_from_variant(variant)
    except Exception as e:
        _die(f"engine validation failed: {e}")
    print(f"[info] Engine {factory} is valid. Ready for `pio train`.")


def cmd_run(args: argparse.Namespace) -> None:
    """Call a ``module:callable`` with the engine dir on ``sys.path``
    (the reference's ``pio run`` submits a main class); a returned value
    is printed."""
    from predictionio_tpu_torch.utils.imports import resolve_spec

    sys.path.insert(0, os.path.abspath(args.engine_dir))
    rv = resolve_spec(args.main)(*args.args)
    if rv is not None:
        print(rv)


def shell_namespace() -> Dict[str, Any]:
    """What ``shell`` preloads: the package, the storage, ``data/store``
    and the port's ``pypio``, initialised on that storage."""
    import predictionio_tpu_torch
    from predictionio_tpu_torch import pypio
    from predictionio_tpu_torch.data import store

    storage = get_storage()
    pypio.init(storage)
    return {"predictionio_tpu_torch": predictionio_tpu_torch,
            "storage": storage, "store": store, "pypio": pypio}


def cmd_shell(args: argparse.Namespace) -> None:
    """Interactive prompt with the framework loaded (the reference's
    ``pio-shell --with-pyspark``): the storage and the ``pypio`` bridge
    are ready before the prompt."""
    import code

    banner = (f"predictionio_tpu_torch {__version__} shell\n"
              "preloaded: predictionio_tpu_torch, storage (Storage), store "
              "(PEventStore/LEventStore API), pypio (initialized: "
              "pypio.find_events('<app>') -> DataFrame)\n"
              'try: list(store.find("MyApp1", limit=3))')
    code.interact(banner=banner, local=shell_namespace())


def cmd_dashboard(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.tools.dashboard import Dashboard

    print(f"[info] Dashboard on {args.ip}:{args.port}", flush=True)
    Dashboard(host=args.ip, port=args.port).run()


def cmd_adminserver(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.tools.admin import AdminServer

    print(f"[info] Admin server on {args.ip}:{args.port}", flush=True)
    AdminServer(host=args.ip, port=args.port).run()


def _app_id_for(args: argparse.Namespace) -> int:
    if args.appid is not None:
        return args.appid
    if args.app_name:
        app = get_storage().meta.get_app_by_name(args.app_name) or _die(
            f"no app {args.app_name!r}")
        return app.id
    _die("need --appid or --app-name")


def cmd_export(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.tools.export_import import export_events

    app_id = _app_id_for(args)
    with open(args.output, "w", encoding="utf-8") as f:
        n = export_events(app_id, f)
    print(f"[info] Exported {n} events to {args.output}")


def cmd_import(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.tools.export_import import import_events

    app_id = _app_id_for(args)
    with open(args.input, "r", encoding="utf-8") as f:
        n = import_events(app_id, f)
    print(f"[info] Imported {n} events.")


def cmd_status(args: argparse.Namespace) -> None:
    import torch

    from predictionio_tpu_torch.utils.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        _die(str(e))
    print(f"[info] predictionio_tpu_torch {__version__}")
    try:
        backends = get_storage().verify()
    except Exception as e:
        _die(f"storage connectivity FAILED: {e}")
    for repo, backend in backends.items():
        print(f"[info] {repo}: {backend} (ok)")
    print(f"[info] torch {torch.__version__} (CUDA {torch.version.cuda})")
    if dev.type == "cuda":
        print(f"[info] device: {torch.cuda.get_device_name(dev)}")
    else:
        print("[info] device: cpu")
    print("[info] status: all systems go")


def cmd_fsck(args: argparse.Namespace) -> None:
    """Offline integrity scan of every persisted artifact under the
    storage home. Exit codes: 0 = clean, 1 = operational error, 2 =
    corruption present (unrepaired), 3 = corruption found and repaired
    — distinct codes so a cron wrapper can page on 2 but merely log 3."""
    from predictionio_tpu_torch.data.pel_integrity import fsck_home
    from predictionio_tpu_torch.storage.registry import StorageConfig

    home = args.home or StorageConfig.from_env().home
    if not os.path.isdir(home):
        _die(f"storage home not found: {home}")
    try:
        report = fsck_home(home, repair=args.repair)
    except OSError as e:
        _die(f"fsck failed: {e}")
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for a in report["artifacts"]:
            name = os.path.basename(str(a["path"]))
            extra = ""
            if a["artifact"] == "eventlog":
                extra = (f" v{a['version']} records={a['records']}"
                         f" corrupt={a['corrupt']}")
                if a["torn_offset"] is not None:
                    extra += f" torn@{a['torn_offset']}"
                if a["quarantine"]:
                    extra += f" quarantined→{a['quarantine']}"
            elif a["artifact"] == "segment":
                extra = f" state={a.get('state')} records={a.get('records')}"
                if a.get("cols_status"):
                    extra += f" cols={a['cols_status']}"
                if a.get("detail"):
                    extra += f" ({a['detail']})"
            print(f"[fsck] {a['artifact']:<9} {name}: {a['status']}{extra}")
        for q in report["quarantines"]:
            print(f"[fsck] quarantine sidecar: {q}")
        print(f"[fsck] checked={report['checked']} clean={report['clean']} "
              f"corrupt={report['corrupt']} repaired={report['repaired']} "
              f"unchecksummed={report['unchecksummed']} "
              f"cold={report.get('cold', 0)}")
    if report["corrupt"]:
        raise SystemExit(2)
    if report["repaired"]:
        raise SystemExit(3)


def cmd_lint(args: argparse.Namespace) -> None:
    """Static invariant analysis over the port's tree (stdlib ``ast``
    only: runs with no card and no torch). Exits 0 when every finding is
    baselined or suppressed, 1 otherwise."""
    from predictionio_tpu_torch.analysis.runner import run_lint

    try:
        report = run_lint(
            root=args.root,
            rules=args.rule or None,
            baseline=args.baseline,
            use_baseline=not args.no_baseline,
        )
    except ValueError as e:
        _die(str(e))
    if args.json:
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        for f in report.findings:
            print(f.render())
        print(f"[lint] rules={','.join(report.rules)} "
              f"files={report.files} findings={len(report.findings)} "
              f"baselined={len(report.baselined)} "
              f"suppressed={report.suppressed} "
              f"({report.duration_s:.2f}s)")
        for key in report.stale_baseline:
            print(f"[lint] warning: stale baseline entry (no longer "
                  f"fires): {key}")
    if not report.ok:
        raise SystemExit(1)


def cmd_segments(args: argparse.Namespace) -> None:
    """Operate the partitioned event log: show segment layout, force a
    rollover, compact sealed segments into columnar sidecars, or ship
    them to the cold tier (PIO_SEGMENT_COLD)."""
    import re as _re

    store = get_storage().events
    if not hasattr(store, "namespaces") or not hasattr(store, "_dir"):
        _die("pio segments requires the EVENTLOG backend "
             f"(configured backend: {type(store).__name__})")
    # open every namespace present on disk, not just ones touched in
    # this process
    names = sorted(os.listdir(store._dir)) if os.path.isdir(store._dir) else []
    for fn in names:
        m = _re.match(r"^events_(\d+)(?:_(\d+))?\.pel$", fn)
        if m:
            store._ns(int(m.group(1)),
                      int(m.group(2)) if m.group(2) else None)
    namespaces = store.namespaces()
    if not namespaces:
        print("[segments] no event-log namespaces found")
        return
    acted = {"rolled": 0, "compacted": 0, "shipped": 0}
    report = []
    for ns in namespaces:
        if args.action == "roll":
            if ns.roll():
                acted["rolled"] += 1
        elif args.action == "compact":
            for seg in list(ns.sealed):
                if seg.meta.cols is None and seg.meta.records:
                    try:
                        ns.compact(seg)
                        acted["compacted"] += 1
                    except (IOError, OSError) as e:
                        print(f"[segments] compact {seg.meta.file}: {e}")
        elif args.action == "ship":
            from predictionio_tpu_torch.utils.integrity import IntegrityError

            for seg in list(ns.sealed):
                if seg.meta.state == "sealed":
                    try:
                        if ns.ship(seg, verify=getattr(args, "verify",
                                                       False)):
                            acted["shipped"] += 1
                    except (IOError, OSError, IntegrityError) as e:
                        print(f"[segments] ship {seg.meta.file}: {e}")
        active_bytes = (os.path.getsize(ns.base_path)
                        if os.path.exists(ns.base_path) else 0)
        segs = [s.meta.to_dict() for s in ns.sealed]
        report.append({"namespace": ns.namespace_tag(),
                       "active_bytes": active_bytes,
                       "sealed": segs})
    if args.json:
        print(json.dumps({"namespaces": report, **acted},
                         indent=2, sort_keys=True))
        return
    for entry in report:
        segs = entry["sealed"]
        compacted = sum(1 for s in segs if s["cols"])
        cold = sum(1 for s in segs if s["state"] == "cold")
        print(f"[segments] {entry['namespace']}: "
              f"{len(segs)} sealed ({compacted} compacted, {cold} cold), "
              f"active {entry['active_bytes']} B")
        for s in segs:
            marks = "".join((
                "C" if s["cols"] else "-",
                "S" if s["state"] == "cold" else "-",
                "#" if s["sha256"] else "-",
            ))
            print(f"[segments]   {s['file']} [{marks}] "
                  f"records={s['records']} bytes={s['bytes']}")
    if args.action not in ("status", "show"):
        print(f"[segments] rolled={acted['rolled']} "
              f"compacted={acted['compacted']} shipped={acted['shipped']}")


def cmd_daemon(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.tools.supervise import (
        Supervisor,
        normalize_command,
    )

    cmd = normalize_command(args.command)
    if not cmd:
        _die("pio daemon: no command given")
    sup = Supervisor(cmd, health_url=args.health_url,
                     health_interval=args.health_interval,
                     health_grace=args.health_grace,
                     max_restarts=args.max_restarts,
                     restart_window=args.restart_window,
                     term_grace=args.term_grace,
                     pidfile=args.pidfile)
    raise SystemExit(sup.run())


def cmd_failover(args: argparse.Namespace) -> None:
    """Event-plane failover (no torch): ``--target URL`` promotes a
    follower by hand (POST /repl/promote, refused while the current
    leader's lease is live, so it cannot split-brain); ``--drill`` runs
    the kill -9 drill of ``server/repl_server.py`` and prints the proof
    document as one JSON line."""
    if args.target:
        from predictionio_tpu_torch.server.repl_server import FollowerClient

        doc = FollowerClient(args.target, timeout=args.timeout).promote()
        print(json.dumps(doc, indent=2 if args.json else None,
                         sort_keys=True))
        if doc.get("role") != "leader":
            sys.exit(1)
        return
    if not args.drill:
        _die("pio failover needs --drill or --target URL")
    import tempfile

    from predictionio_tpu_torch.server.repl_server import run_failover_drill

    base = args.dir or tempfile.mkdtemp(prefix="pio-failover-")
    proof = run_failover_drill(
        base, events=args.events, kill_after=args.kill_after,
        lease_ttl=args.lease_ttl,
        log=lambda s: print(f"[failover] {s}", file=sys.stderr))
    print(json.dumps(proof, indent=2 if args.json else None,
                     sort_keys=True))
    if not proof.get("ok"):
        sys.exit(3)


def cmd_trace(args: argparse.Namespace) -> None:
    """Tail or grep the span JSONL that servers started with
    ``--tracing`` write. Filters compose; ``--tree`` re-assembles whole
    traces into the indented view the slow-query log prints."""
    from predictionio_tpu_torch.storage.registry import StorageConfig
    from predictionio_tpu_torch.utils import tracing

    path = args.file or tracing.default_trace_path(
        StorageConfig.from_env().home)
    # include the rotated predecessor so recent history survives rotation
    paths = [p for p in (path + ".1", path) if os.path.exists(p)]
    if not paths:
        _die(f"no trace file at {path} (start a server with --tracing)")
    spans: List[Dict[str, Any]] = []
    for fp in paths:
        with open(fp, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    spans.append(json.loads(line))
                except ValueError:
                    continue  # torn tail from a live writer

    def keep(s: Dict[str, Any]) -> bool:
        if args.trace_id and s.get("traceId") != args.trace_id:
            return False
        if args.errors_only and s.get("status") != "error":
            return False
        if args.min_ms and s.get("durationUs", 0) < args.min_ms * 1000:
            return False
        if args.grep and args.grep not in json.dumps(s, sort_keys=True):
            return False
        return True

    spans = [s for s in spans if keep(s)]
    if not spans:
        print("[info] no spans matched")
        return
    if args.tree:
        by_trace: Dict[str, List[Dict[str, Any]]] = {}
        for s in spans:
            by_trace.setdefault(str(s.get("traceId", "?")), []).append(s)
        for tid in list(by_trace)[-args.limit:]:
            print(f"trace {tid}:")
            print(tracing.render_trace_tree(by_trace[tid]))
    else:
        for s in spans[-args.limit:]:
            print(json.dumps(s, sort_keys=True))


def _add_observability_flags(sp: argparse.ArgumentParser) -> None:
    """Tracing and access-log flags shared by ``eventserver`` and ``deploy``."""
    sp.add_argument("--tracing", action="store_true",
                    help="request-scoped tracing: root span per request, "
                         "child spans through ingest/serving/storage, "
                         "ring-buffered for /traces and exported to a "
                         "span JSONL file (see `trace`)")
    sp.add_argument("--trace-sample", type=float, default=1.0,
                    help="probability a trace is exported to the JSONL "
                         "file; errors and slow spans always export "
                         "(ring buffer + /traces see every span)")
    sp.add_argument("--trace-file",
                    help="span JSONL path (default: "
                         "<home>/traces/spans.jsonl; '' = ring only)")
    sp.add_argument("--slow-query-ms", type=float, default=0.0,
                    help="log the full span tree of any request slower "
                         "than this, regardless of sampling "
                         "(0 = disabled)")
    sp.add_argument("--access-log", action="store_true",
                    help="one structured JSON line per request (method, "
                         "path, status, duration, trace id) on the "
                         "'pio.access' logger")


def _add_incident_flags(sp: argparse.ArgumentParser) -> None:
    """Incident flight-recorder flags shared by the long-lived server
    verbs (eventserver, deploy)."""
    sp.add_argument("--incident-dir", default="auto", metavar="PATH",
                    help="incident-bundle store directory (default: "
                         "<storage home>/incidents)")
    sp.add_argument("--no-incidents", action="store_true",
                    help="disable automatic postmortem capture")


def _incident_dir(args: argparse.Namespace) -> Optional[str]:
    return None if args.no_incidents else args.incident_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.tools.cli",
        description="PredictionIO on PyTorch and CUDA. Verbs: app, "
                    "accesskey, eventserver, import, export, train, deploy, "
                    "undeploy, eval, evals, status, trace, models, variants, "
                    "incidents, daemon, failover, router, slo, top, "
                    "doctor, dashboard, adminserver, template, build, run, "
                    "shell, version.")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ap = sub.add_parser("app", aliases=["apps"],
                        help="manage apps, channels, and QoS quotas")
    aps = ap.add_subparsers(dest="app_cmd", required=True)
    x = aps.add_parser("new"); x.add_argument("name")
    x.add_argument("--description"); x.add_argument("--access-key")
    aps.add_parser("list")
    x = aps.add_parser("show"); x.add_argument("name")
    x = aps.add_parser("delete"); x.add_argument("name")
    x = aps.add_parser("data-delete"); x.add_argument("name")
    x.add_argument("--channel")
    x = aps.add_parser("channel-new"); x.add_argument("name"); x.add_argument("channel")
    x = aps.add_parser("channel-delete"); x.add_argument("name"); x.add_argument("channel")
    x = aps.add_parser(
        "quota",
        help="show or set per-app QoS overrides (quotas.json; "
             "hot-reloaded by every server within ~1s)")
    x.add_argument("name", help="app name (overrides key on the app id)")
    x.add_argument("--rate", type=float,
                   help="sustained ingest events/second (0 = unlimited)")
    x.add_argument("--burst", type=float,
                   help="ingest bucket depth (0 = rate for 1s, min 1)")
    x.add_argument("--weight", type=float,
                   help="weighted share of engine-server inflight and of "
                        "the router retry budget at saturation")
    x.add_argument("--writer-shards", type=int,
                   help="ACTIVE-segment writer shards for this app's "
                        "event namespaces (hot-partition relief)")
    x.add_argument("--deadline-ms", type=float,
                   help="router deadline cap for this app's queries "
                        "(0 = router default)")
    x.add_argument("--clear", action="append", metavar="FIELD",
                   choices=["rate", "burst", "weight", "writer-shards",
                            "deadline-ms"],
                   help="drop one override, back to the fleet default "
                        "(repeatable)")
    x.add_argument("--quotas-file",
                   help="explicit quotas.json path (default: "
                        "<storage home>/quotas.json)")
    ap.set_defaults(fn=cmd_app)

    ak = sub.add_parser("accesskey", help="manage access keys")
    aks = ak.add_subparsers(dest="ak_cmd", required=True)
    x = aks.add_parser("new"); x.add_argument("app_name"); x.add_argument("--events")
    x = aks.add_parser("list"); x.add_argument("app_name", nargs="?")
    x = aks.add_parser("delete"); x.add_argument("key")
    ak.set_defaults(fn=cmd_accesskey)

    es = sub.add_parser("eventserver", help="start the event server")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true")
    es.add_argument("--ingest-batching", action="store_true",
                    help="group-commit concurrent single-event POSTs "
                         "into one storage commit per (app, channel); "
                         "201 is still acked only after the commit")
    es.add_argument("--ingest-max-batch", type=int, default=512,
                    help="max events per group commit")
    es.add_argument("--ingest-queue-depth", type=int, default=4096,
                    help="pending-event limit before POSTs get 429 + "
                         "Retry-After backpressure")
    es.add_argument("--durable-acks", action="store_true",
                    help="fsync storage before acking 201 (survives "
                         "power loss, not just process death); group "
                         "commit amortizes the sync per batch")
    es.add_argument("--segment-maintenance", action="store_true",
                    help="background compaction of sealed event-log "
                         "segments into columnar sidecars, plus "
                         "cold-tier shipping when PIO_SEGMENT_COLD "
                         "is configured (EVENTLOG backend only)")
    es.add_argument("--auth-cache-ttl", type=float, default=30.0,
                    help="access-key/channel auth cache TTL seconds "
                         "(0 disables; in-process key mutations "
                         "invalidate immediately regardless)")
    es.add_argument("--tenant-quotas", metavar="PATH", default=None,
                    help="per-app QoS policy file (default: "
                         "<storage home>/quotas.json, managed by "
                         "'app quota'; hot-reloaded)")
    es.add_argument("--lease-home", metavar="DIR", default=None,
                    help="shared directory holding the event-plane "
                         "leader lease; setting it turns on the "
                         "replicated event plane (leader election with "
                         "fencing tokens, follower streaming — "
                         "server/repl_server.py)")
    es.add_argument("--advertise-url", metavar="URL", default=None,
                    help="base URL peers and redirected clients reach "
                         "THIS node at (default: http://<ip>:<port>; "
                         "also the lease owner identity)")
    es.add_argument("--replicate-to", action="append", metavar="URL",
                    help="follower base URL to stream the event log to "
                         "when this node leads (repeatable; a node "
                         "never replicates to its own advertise URL)")
    es.add_argument("--lease-ttl", type=float, default=2.0,
                    help="event-plane lease TTL seconds: a leader that "
                         "stops heartbeating is superseded after this "
                         "(promotion latency trades against false "
                         "failover on GC/IO stalls)")
    _add_observability_flags(es)
    _add_incident_flags(es)
    es.set_defaults(fn=cmd_eventserver)
    tp = sub.add_parser("train", help="train an engine instance")
    tp.add_argument("--engine-dir", default=".")
    tp.add_argument("-e", "--variant")
    tp.add_argument("--batch", default="", help="batch label of the instance")
    tp.add_argument("-v", "--verbose", action="count", default=0)
    tp.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; "
                         "'cpu' trains on the CPU)")
    tp.add_argument("--resume", action="store_true",
                    help="resume an interrupted train from its latest "
                         "mid-train checkpoint (the port's own checkpoints "
                         "under <home>/train_ckpt_torch only; the JAX "
                         "package's Orbax checkpoints are not read)")
    tp.add_argument("--no-scan-cache", action="store_true",
                    help="bypass the columnar snapshot cache and rescan "
                         "the full event log")
    tp.add_argument("--scan-workers", type=int,
                    help="parallel segment scans per training read "
                         "(default: PIO_SCAN_WORKERS)")
    tp.add_argument("--no-mesh", action="store_true",
                    help="single-device training: no device mesh from "
                         "meshConf")
    tp.add_argument("--read-from", choices=("leader", "follower", "any"),
                    default="leader",
                    help="which event-plane node training reads come "
                         "from: 'follower' trains off a replicated "
                         "home (--replica-home / PIO_REPL_REPLICA_HOME) "
                         "so scans never contend with leader ingest; "
                         "'any' prefers the replica when present and "
                         "falls back to the leader")
    tp.add_argument("--replica-home", metavar="DIR",
                    help="storage home of a replicated follower to "
                         "train from (default: PIO_REPL_REPLICA_HOME)")
    tp.add_argument("--continuous", action="store_true",
                    help="run the supervised continuous-training loop: "
                         "single-writer lease with fencing tokens, "
                         "watermark-triggered delta trains (resumable "
                         "after kill -9), guardrail-gated promotion "
                         "through the model registry, /reload push, and "
                         "a live-metrics bake window with automatic "
                         "rollback (server/trainer.py)")
    tp.add_argument("--app", help="app whose events drive the loop "
                                  "(default: variant datasource appName)")
    tp.add_argument("--channel", help="optional event channel")
    tp.add_argument("--min-delta-events", type=int, default=1,
                    help="train only when at least this many new events "
                         "arrived since the last completed cycle")
    tp.add_argument("--poll-interval", type=float, default=5.0,
                    help="seconds between watermark polls when idle")
    tp.add_argument("--lease-ttl", type=float, default=30.0,
                    help="trainer lease TTL seconds; a trainer that "
                         "stops heartbeating is supersedable after this")
    tp.add_argument("--retain", type=int, default=5,
                    help="registry generations kept beyond the champion")
    tp.add_argument("--guardrail-holdout", type=int, default=200,
                    help="newest-N feedback events scored champion vs "
                         "candidate before promotion")
    tp.add_argument("--guardrail-max-regress", type=float, default=0.10,
                    help="refuse candidates whose holdout RMSE is worse "
                         "than the champion's by more than this fraction")
    tp.add_argument("--guardrail-min-events", type=int, default=10,
                    help="below this many scoreable holdout pairs the "
                         "gate passes trivially")
    tp.add_argument("--gate", choices=("offline", "online", "both", "eval"),
                    default="offline",
                    help="promotion gate mode: 'offline' scores the "
                         "candidate on held-out feedback (default); "
                         "'online' judges the CHALLENGER arm's accrued "
                         "live metrics (pio_variant_online_rmse, fed by "
                         "real traffic on a --variants replica) against "
                         "the champion's; 'both' requires both to pass; "
                         "'eval' consults the latest persisted `pio eval` "
                         "sweep leaderboard and refuses candidates the "
                         "sweep ranked below the current champion")
    tp.add_argument("--eval-leaderboard-max-age", type=float, default=0.0,
                    help="with --gate eval: leaderboards older than this "
                         "many seconds are considered stale and the gate "
                         "passes trivially (0 = never stale)")
    tp.add_argument("--online-challenger", default="challenger",
                    help="variant name whose accrued online RMSE the "
                         "online gate judges")
    tp.add_argument("--online-champion", default="champion",
                    help="variant name serving as the online baseline")
    tp.add_argument("--online-min-pairs", type=int, default=20,
                    help="below this many fleet-wide online rated pairs "
                         "the online gate passes trivially")
    tp.add_argument("--online-max-regress", type=float, default=None,
                    help="online gate regression tolerance (default: "
                         "--guardrail-max-regress)")
    tp.add_argument("--bake-seconds", type=float, default=0.0,
                    help="watch live serving metrics for this long after "
                         "promotion and auto-roll-back on regression "
                         "(0 = no bake window)")
    tp.add_argument("--bake-error-rate", type=float, default=0.01,
                    help="bake: roll back when the 5xx fraction over the "
                         "window exceeds this")
    tp.add_argument("--bake-p95-ratio", type=float, default=2.0,
                    help="bake: roll back when window p95 exceeds the "
                         "pre-swap baseline by this factor")
    tp.add_argument("--reload-url", action="append",
                    help="engine-server base URL to /reload and scrape "
                         "(repeatable)")
    tp.add_argument("--router-url",
                    help="fleet-router base URL; promotion then pushes "
                         "POST /router/reload?rolling=1 instead of "
                         "direct /reload calls")
    tp.add_argument("--fleet-manifest",
                    help="router manifest file; its replica URLs are "
                         "used for direct reload + bake scraping")
    tp.add_argument("--max-cycles", type=int,
                    help="stop after N wake cycles (smoke/testing; "
                         "default: run until SIGTERM)")
    tp.add_argument("--metrics-port", type=int, default=None,
                    help="continuous mode: serve /metrics, "
                         "/metrics/history and /health on this port so "
                         "the router federates the trainer (manifest "
                         "'observe=1' line); 0 = ephemeral, unset = "
                         "no listener")
    _add_incident_flags(tp)
    tp.set_defaults(fn=cmd_train)
    dp = sub.add_parser("deploy", help="serve the latest trained instance")
    dp.add_argument("--engine-dir", default=".")
    dp.add_argument("-e", "--variant")
    dp.add_argument("--ip", default="0.0.0.0")
    dp.add_argument("--port", type=int, default=8000)
    dp.add_argument("--engine-instance-id")
    dp.add_argument("--feedback", action="store_true")
    dp.add_argument("--feedback-url",
                    help="Event Server base URL (e.g. http://host:7070); "
                         "feedback then posts through its authenticated "
                         "HTTP API instead of writing storage directly")
    dp.add_argument("--feedback-accesskey",
                    help="access key for --feedback-url")
    dp.add_argument("--feedback-channel",
                    help="optional channel name for feedback events")
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
    dp.add_argument("--query-timeout-ms", type=float, default=0.0,
                    help="per-request deadline for /queries.json; a query "
                         "still running at the deadline returns 504 "
                         "(0 = no deadline)")
    dp.add_argument("--max-inflight", type=int, default=0,
                    help="concurrent query cap; excess requests are shed "
                         "immediately with 503 + Retry-After "
                         "(0 = unlimited)")
    dp.add_argument("--variants", default=None, metavar="SPEC",
                    help="multi-model serving: keep several registry "
                         "generations resident and split traffic by a "
                         "deterministic sticky hash, e.g. "
                         "'champion:9,challenger:1' (name[@gen]:weight; "
                         "'champion' = registry champion, an unpinned "
                         "other name = newest non-champion generation). "
                         "The first arm is the default and absorbs a "
                         "failed arm's weight")
    dp.add_argument("--variant-salt", default="pio",
                    help="salt for the sticky split hash; change it to "
                         "reshuffle which entities land on which arm")
    dp.add_argument("--tenant-quotas", metavar="PATH", default=None,
                    help="per-app QoS policy file driving weighted-fair "
                         "admission under --max-inflight (default: "
                         "<storage home>/quotas.json; hot-reloaded)")
    dp.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; "
                         "'cpu' serves on the CPU)")
    _add_observability_flags(dp)
    _add_incident_flags(dp)
    dp.set_defaults(fn=cmd_deploy)

    rt = sub.add_parser(
        "router",
        help="fleet router: one endpoint over N engine-server replicas")
    rts = rt.add_subparsers(dest="router_cmd", required=True)
    x = rts.add_parser("serve", help="start the router")
    x.add_argument("--replicas",
                   help="comma-separated replica URLs (host:port or "
                        "http://host:port)")
    x.add_argument("--manifest",
                   help="file with one replica URL per line, re-read on "
                        "mtime change (# comments ok)")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=8100)
    x.add_argument("--health-interval", type=float, default=1.0,
                   help="seconds between active /health probe rounds")
    x.add_argument("--retry-budget", type=float, default=0.1,
                   help="retry/hedge tokens earned per live request; "
                        "bounds retries to this fraction of traffic")
    x.add_argument("--no-hedge", action="store_true",
                   help="disable tail-latency hedging of /queries.json")
    x.add_argument("--hedge-min-ms", type=float, default=20.0,
                   help="hedge delay floor (used until enough latency "
                        "samples exist for a p95)")
    x.add_argument("--deadline-ms", type=float, default=10000.0,
                   help="default end-to-end budget per client request "
                        "(an inbound X-PIO-Deadline-Ms only tightens it)")
    x.add_argument("--per-try-timeout-ms", type=float, default=0.0,
                   help="cap any single replica attempt (0 = the "
                        "remaining deadline)")
    x.add_argument("--drain-timeout", type=float, default=30.0,
                   help="rolling reload: max seconds to wait for a "
                        "replica's in-flight requests to finish")
    x.add_argument("--ready-timeout", type=float, default=120.0,
                   help="rolling reload: max seconds for /reload + "
                        "AOT re-warm readiness per replica")
    x.add_argument("--tenant-quotas", metavar="PATH", default=None,
                   help="per-app QoS policy file driving per-tenant "
                        "retry/hedge budgets and deadline caps "
                        "(default: <storage home>/quotas.json; "
                        "hot-reloaded)")
    x.add_argument("--slo-config", metavar="PATH", default=None,
                   help="SLO objectives file for the burn-rate engine "
                        "(default: ./conf/slo.json if present, else the "
                        "built-in prober objectives)")
    x.add_argument("--scrape-interval", type=float, default=10.0,
                   help="seconds between metrics-history scrape ticks "
                        "(local registry + fleet federation + SLO "
                        "evaluation)")
    x.add_argument("--probe-interval", type=float, default=2.0,
                   help="seconds between synthetic canary probes "
                        "(X-PIO-Probe queries feeding the SLO series; "
                        "0 disables the prober)")
    x.add_argument("--pool-spawn", metavar="CMD",
                   help="own the replica fleet: spawn each replica with "
                        "this command ('{port}' substituted; a bare verb "
                        "such as 'deploy --port {port}' runs this CLI), "
                        "supervise it, and rewrite --manifest on "
                        "membership changes (enables the autoscaler and "
                        "POST /pool/* endpoints)")
    x.add_argument("--min-replicas", type=int, default=1,
                   help="pool floor: replicas started at boot and the "
                        "scale-down limit")
    x.add_argument("--max-replicas", type=int, default=4,
                   help="pool ceiling: the autoscaler never scales past "
                        "this")
    x.add_argument("--autoscale-interval", type=float, default=5.0,
                   help="seconds between autoscaler control ticks")
    x.add_argument("--no-autoscale", action="store_true",
                   help="own the pool but hold the fleet size fixed "
                        "(manual scaling via POST /pool/add|remove)")
    x.add_argument("--remediations", metavar="PATH", default=None,
                   help="remediation playbooks for the auto-remediator "
                        "(default: ./conf/remediations.json if present, "
                        "else built-ins)")
    _add_observability_flags(x)
    _add_incident_flags(x)
    x = rts.add_parser("status", help="replica states from a running router")
    x.add_argument("--url", default="http://localhost:8100")
    x.add_argument("--timeout", type=float, default=10.0)
    x = rts.add_parser("reload", help="reload the fleet through the router")
    x.add_argument("--url", default="http://localhost:8100")
    x.add_argument("--rolling", action="store_true",
                   help="drain + reload + re-warm one replica at a time "
                        "(zero-downtime); default reloads all at once")
    x.add_argument("--timeout", type=float, default=600.0)
    rt.set_defaults(fn=cmd_router)

    ev = sub.add_parser("eval", help="hyperparameter evaluation (grid search)")
    ev.add_argument("evaluation",
                    help="module:attr of the Evaluation, or the literal "
                         "'leaderboard' to inspect a persisted sweep "
                         "leaderboard (no engine code loaded)")
    ev.add_argument("engine_params_generator", nargs="?", default=None,
                    help="module:attr of the generator (after "
                         "'leaderboard': an optional evaluation instance "
                         "id, default latest)")
    ev.add_argument("--engine-dir", default=".")
    ev.add_argument("-v", "--verbose", action="count", default=0)
    ev.add_argument("--output", help="write full results JSON here")
    ev.add_argument("--distributed", action="store_true",
                    help="run the grid as sweep programs: one build per "
                         "program geometry bucket, training and scoring "
                         "on the device, instead of one train per "
                         "candidate per fold scored query by query")
    ev.add_argument("--sweep-shards", type=int, default=0,
                    help="deal each sweep's rows out over this many "
                         "devices (0 = one device; a pool too small "
                         "warns and runs unsharded)")
    ev.add_argument("--json", action="store_true",
                    help="print the leaderboard document as JSON")
    ev.add_argument("--device", default=None,
                    help="torch device to evaluate on (default: cuda; "
                         "'cpu' evaluates on the CPU)")
    ev.set_defaults(fn=cmd_eval)

    evs = sub.add_parser(
        "evals", help="inspect past evaluation instances (no torch)")
    evsub = evs.add_subparsers(dest="evals_cmd", required=True)
    evl = evsub.add_parser("list", help="list evaluation instances")
    evl.add_argument("--json", action="store_true")
    evw = evsub.add_parser(
        "show", help="one instance: status, results/error, leaderboard")
    evw.add_argument("instance_id")
    evw.add_argument("--json", action="store_true")
    evs.set_defaults(fn=cmd_evals)

    bp = sub.add_parser("batchpredict", help="bulk predictions from a JSONL file")
    bp.add_argument("--engine-dir", default=".")
    bp.add_argument("-e", "--variant")
    bp.add_argument("--input", required=True)
    bp.add_argument("--output", required=True)
    bp.add_argument("--engine-instance-id")
    bp.add_argument("--batch-size", type=int, default=1024)
    bp.add_argument("--shards", type=int, default=0,
                    help="serve ANN-indexed engines over an N-way "
                         "item-sharded retrieval mesh (needs >= N slots; "
                         "fewer serve unsharded)")
    bp.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; "
                         "'cpu' scores on the CPU)")
    bp.set_defaults(fn=cmd_batchpredict)

    ex = sub.add_parser("export", help="export events to JSONL")
    ex.add_argument("--appid", type=int)
    ex.add_argument("--app-name")
    ex.add_argument("--output", required=True)
    ex.set_defaults(fn=cmd_export)

    im = sub.add_parser("import", help="import events from JSONL")
    im.add_argument("--appid", type=int)
    im.add_argument("--app-name")
    im.add_argument("--input", required=True)
    im.set_defaults(fn=cmd_import)

    stp = sub.add_parser("status", help="check storage + device connectivity")
    stp.add_argument("--device", default=None,
                     help="torch device to check (default: cuda; 'cpu' "
                          "checks the CPU and needs no card)")
    stp.set_defaults(fn=cmd_status)

    fs = sub.add_parser(
        "fsck",
        help="verify integrity of eventlog segments, snapshot cache, "
             "model blobs, ANN index blobs, and the model registry "
             "(exit 0 clean / 2 corrupt / 3 repaired)")
    fs.add_argument("--home", help="storage home to scan "
                                   "(default: PIO_HOME / ~/.pio_store)")
    fs.add_argument("--repair", action="store_true",
                    help="quarantine torn eventlog tails (copied to a "
                         ".quarantine-<offset> sidecar, then truncated), "
                         "delete corrupt snapshots, delete orphaned "
                         "registry generation dirs, and rewrite registry "
                         "sha256 sidecars from the manifest; corrupt "
                         "model blobs are reported only")
    fs.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON document")
    fs.set_defaults(fn=cmd_fsck)

    sg = sub.add_parser(
        "segments",
        help="inspect/operate the partitioned event log (EVENTLOG "
             "backend): status, force rollover, compact, cold-tier ship")
    sg.add_argument("action", nargs="?", default="status",
                    choices=("status", "show", "roll", "compact", "ship"),
                    help="status (or its alias show) prints the layout")
    sg.add_argument("--json", action="store_true",
                    help="emit the full segment report as JSON")
    sg.add_argument("--verify", action="store_true",
                    help="ship: re-fetch every uploaded object from the "
                         "cold tier and compare sha256 before trusting "
                         "it; a mismatch deletes the cold copy, keeps "
                         "the local file, and fails the ship")
    sg.set_defaults(fn=cmd_segments)

    fo = sub.add_parser(
        "failover",
        help="event-plane failover: promote a follower by hand "
             "(--target) or run the kill -9 drill (--drill) that "
             "proves zero acked loss, sub-second promotion, "
             "stale-epoch refusal, fsck-clean logs, and one coalesced "
             "incident bundle (no torch)")
    fo.add_argument("--drill", action="store_true",
                    help="spawn a leader+follower pair, ingest through "
                         "the follower's 307 redirect, kill -9 the "
                         "leader mid-stream, and print the proof "
                         "document as one JSON line (exit 3 if any "
                         "proof fails)")
    fo.add_argument("--target", metavar="URL",
                    help="follower base URL to promote now (POST "
                         "/repl/promote; refused while the current "
                         "leader's lease is live)")
    fo.add_argument("--dir", metavar="PATH",
                    help="drill working directory (default: a fresh "
                         "temp dir; kept afterward for inspection)")
    fo.add_argument("--events", type=int, default=120,
                    help="drill: total events to ingest")
    fo.add_argument("--kill-after", type=int, default=40,
                    help="drill: kill -9 the leader after this many "
                         "acked events")
    fo.add_argument("--lease-ttl", type=float, default=0.35,
                    help="drill: event-plane lease TTL seconds "
                         "(promotion must still land under 1s "
                         "including the expiry wait)")
    fo.add_argument("--timeout", type=float, default=10.0,
                    help="--target: HTTP timeout seconds")
    fo.add_argument("--json", action="store_true",
                    help="pretty-print the proof document instead of "
                         "one line")
    fo.set_defaults(fn=cmd_failover)

    dm = sub.add_parser(
        "daemon",
        help="supervise a server verb: crash restart with backoff, "
             "health checks, pidfile")
    dm.add_argument("--pidfile")
    dm.add_argument("--health-url")
    dm.add_argument("--health-interval", type=float, default=5.0)
    dm.add_argument("--health-grace", type=float, default=30.0)
    dm.add_argument("--max-restarts", type=int, default=10)
    dm.add_argument("--restart-window", type=float, default=600.0)
    dm.add_argument("--term-grace", type=float, default=10.0,
                    help="seconds between SIGTERM and SIGKILL when "
                         "stopping the child; give the continuous "
                         "trainer enough to finish its cycle and "
                         "release the lease cleanly")
    dm.add_argument("command", nargs=argparse.REMAINDER)
    dm.set_defaults(fn=cmd_daemon)

    tc = sub.add_parser(
        "trace",
        help="tail/grep exported trace spans (JSONL written by servers "
             "started with --tracing)")
    tc.add_argument("--file", help="span JSONL path "
                                   "(default: <home>/traces/spans.jsonl)")
    tc.add_argument("--trace-id", help="only spans of this trace id")
    tc.add_argument("--min-ms", type=float, default=0.0,
                    help="only spans at least this many ms long")
    tc.add_argument("--errors-only", action="store_true",
                    help="only spans that finished in error")
    tc.add_argument("--grep", help="substring filter over the span JSON")
    tc.add_argument("--tree", action="store_true",
                    help="group by trace and render indented span trees")
    tc.add_argument("--limit", type=int, default=50,
                    help="print at most the newest N spans (or traces "
                         "with --tree)")
    tc.set_defaults(fn=cmd_trace)

    ix = sub.add_parser(
        "index",
        help="ANN retrieval index: geometry (M, K, corpus size, code "
             "bytes, HBM estimate), build time, and digest status of "
             "the deployed model's PQ index — reads the artifact "
             "manifest only, torch-free")
    ixs = ix.add_subparsers(dest="index_cmd", required=True)
    x = ixs.add_parser("status",
                       help="inspect the latest COMPLETED instance's "
                            "ann_index.json manifests")
    x.add_argument("--engine-instance-id",
                   help="inspect this instance instead of the latest "
                        "COMPLETED one")
    x.add_argument("--json", action="store_true",
                   help="emit the full report as one JSON document")
    x.add_argument("--shards", type=int, default=0,
                   help="also print the per-shard layout (rows, code "
                        "bytes, per-device HBM) for an N-way serving "
                        "mesh — pure manifest math, still torch-free")
    ix.set_defaults(fn=cmd_index)

    md = sub.add_parser(
        "models",
        help="generation-aware model registry: list the promotion "
             "history, promote a generation, or roll back the champion")
    mds = md.add_subparsers(dest="models_cmd", required=True)
    x = mds.add_parser("list", help="generations, statuses, champion, "
                                    "fence token")
    x.add_argument("--json", action="store_true",
                   help="emit the registry state as one JSON document")
    x.add_argument("--replica-url", action="append", metavar="URL",
                   help="also show which generations this serving "
                        "replica holds resident (repeatable; reads the "
                        "replica's /health variants block)")
    x = mds.add_parser("promote",
                       help="move the champion pointer to a generation "
                            "(then /reload the fleet to swap serving)")
    x.add_argument("generation", type=int)
    x = mds.add_parser("rollback",
                       help="demote the champion and restore the most "
                            "recently promoted retired generation")
    md.set_defaults(fn=cmd_models)

    vt = sub.add_parser(
        "variants",
        help="multi-model serving: show resident variant sets or "
             "re-weight the live traffic split across the replicas "
             "(probe-then-apply; torch-free)")
    vts = vt.add_subparsers(dest="variants_cmd", required=True)
    x = vts.add_parser("status",
                       help="resident arms, weights, warmup state and "
                            "online score, per replica")
    x.add_argument("--url", action="append", metavar="URL",
                   help="replica base URL, e.g. http://h:8000 "
                        "(repeatable)")
    x.add_argument("--manifest",
                   help="fleet manifest file (router format, one "
                        "replica per line)")
    x.add_argument("--json", action="store_true")
    x.add_argument("--timeout", type=float, default=10.0)
    x = vts.add_parser(
        "set-weights",
        help="re-split live traffic across already-resident arms; every "
             "replica is probed for every named arm BEFORE any replica "
             "is changed")
    x.add_argument("weights", metavar="SPEC",
                   help='e.g. "champion:8,challenger:2" — same grammar '
                        "as deploy --variants, minus generation pins")
    x.add_argument("--url", action="append", metavar="URL",
                   help="replica base URL (repeatable)")
    x.add_argument("--manifest",
                   help="fleet manifest file (router format)")
    x.add_argument("--timeout", type=float, default=10.0)
    vt.set_defaults(fn=cmd_variants)

    ic = sub.add_parser(
        "incidents",
        help="browse incident flight-recorder bundles (postmortems)")
    ics = ic.add_subparsers(dest="inc_cmd", required=True)
    x = ics.add_parser("list", help="resident bundles, newest first")
    x.add_argument("--dir", metavar="PATH",
                   help="incident store (default: "
                        "<storage home>/incidents)")
    x.add_argument("--json", action="store_true",
                   help="summary rows as JSON")
    x.set_defaults(fn=cmd_incidents)
    x = ics.add_parser("show",
                       help="one bundle's manifest (default: newest)")
    x.add_argument("id", nargs="?",
                   help="bundle id from 'pio incidents list'")
    x.add_argument("--dir", metavar="PATH",
                   help="incident store (default: "
                        "<storage home>/incidents)")
    x.add_argument("--json", action="store_true",
                   help="the full bundle (manifest + parsed files) as "
                        "JSON")
    x.set_defaults(fn=cmd_incidents)
    x = ics.add_parser("prune",
                       help="drop the oldest bundles beyond --retain")
    x.add_argument("--retain", type=int, default=20,
                   help="bundles to keep (newest first)")
    x.add_argument("--dir", metavar="PATH",
                   help="incident store (default: "
                        "<storage home>/incidents)")
    x.set_defaults(fn=cmd_incidents)

    sp = sub.add_parser(
        "slo", help="SLO burn-rate status from a running router")
    sps = sp.add_subparsers(dest="slo_cmd", required=True)
    x = sps.add_parser("status", help="print burn rates per SLO "
                                      "(exit 1 while fast-burning)")
    x.add_argument("--url", default="http://localhost:8100",
                   help="router base URL")
    x.add_argument("--json", action="store_true",
                   help="raw /slo/status JSON instead of the table")
    x.add_argument("--timeout", type=float, default=10.0)
    x.set_defaults(fn=cmd_slo)

    tp = sub.add_parser(
        "top", help="live fleet view from a running router "
                    "(QPS, latency, variants, tenants, SLOs, replicas)")
    tp.add_argument("--url", default="http://localhost:8100",
                    help="router base URL")
    tp.add_argument("--window", default="1m",
                    help="rate/quantile window over federated history "
                         "(e.g. 30s, 1m, 5m)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds")
    tp.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clear)")
    tp.add_argument("--json", action="store_true",
                    help="raw /top JSON once and exit")
    tp.add_argument("--watch", type=float, default=0.0, metavar="N",
                    help="redraw every N seconds (overrides --interval "
                         "and --once; ctrl-C exits)")
    tp.add_argument("--timeout", type=float, default=10.0)
    tp.set_defaults(fn=cmd_top)

    dr = sub.add_parser(
        "doctor",
        help="ranked findings from an incident bundle or the live "
             "fleet (exit 0 clean / 1 warn / 2 firing)")
    dr.add_argument("--incident", metavar="ID",
                    help="diagnose a captured bundle ('latest' = "
                         "newest) instead of the live fleet")
    dr.add_argument("--dir", metavar="PATH",
                    help="incident store for --incident (default: "
                         "<storage home>/incidents)")
    dr.add_argument("--url", default="http://localhost:8100",
                    help="router base URL for live diagnosis")
    dr.add_argument("--json", action="store_true",
                    help="findings + exit code as JSON")
    dr.add_argument("--timeout", type=float, default=10.0)
    dr.add_argument("--act", action="store_true",
                    help="map findings onto conf/remediations.json "
                         "playbooks and print the remediation plan "
                         "(dry run: NOTHING executes without --yes)")
    dr.add_argument("--yes", action="store_true",
                    help="with --act: actually execute the plan "
                         "(rate-limited, target-verified, one "
                         "remediation in flight)")
    dr.add_argument("--remediations", metavar="PATH", default=None,
                    help="playbook file for --act (default: "
                         "./conf/remediations.json if present, else "
                         "built-ins)")
    dr.set_defaults(fn=cmd_doctor)

    db = sub.add_parser("dashboard", help="evaluation results dashboard")
    db.add_argument("--ip", default="0.0.0.0")
    db.add_argument("--port", type=int, default=9000)
    db.set_defaults(fn=cmd_dashboard)

    ad = sub.add_parser("adminserver", help="REST admin API")
    ad.add_argument("--ip", default="0.0.0.0")
    ad.add_argument("--port", type=int, default=7071)
    ad.set_defaults(fn=cmd_adminserver)

    ud = sub.add_parser("undeploy", help="stop a running engine server")
    ud.add_argument("--ip", default="127.0.0.1")
    ud.add_argument("--port", type=int, default=8000)
    ud.set_defaults(fn=cmd_undeploy)

    tp = sub.add_parser("template", help="engine templates")
    tps = tp.add_subparsers(dest="tpl_cmd", required=True)
    tps.add_parser("list")
    x = tps.add_parser("new"); x.add_argument("name"); x.add_argument("dir")
    tp.set_defaults(fn=cmd_template)

    bd = sub.add_parser("build", help="validate an engine dir")
    bd.add_argument("--engine-dir", default=".")
    bd.add_argument("-e", "--variant")
    bd.set_defaults(fn=cmd_build)

    rn = sub.add_parser("run", help="run a module:callable in the framework env")
    rn.add_argument("main", help="module:callable")
    rn.add_argument("args", nargs="*")
    rn.add_argument("--engine-dir", default=".")
    rn.set_defaults(fn=cmd_run)

    sh = sub.add_parser("shell", help="interactive framework REPL")
    sh.set_defaults(fn=cmd_shell)

    ln = sub.add_parser(
        "lint",
        help="static invariant analysis of the port: trace-safety (PL01), "
             "jax-free port and torch-free ops-box verbs (PL02), lock "
             "discipline (PL03), registry/docs closure (PL04), resilience "
             "hygiene (PL05) — stdlib ast only, torch-free")
    ln.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON document")
    ln.add_argument("--rule", action="append", metavar="RULE",
                    help="run only this rule family, e.g. PL03 "
                         "(repeatable; default: all)")
    ln.add_argument("--baseline", metavar="PATH",
                    help="baseline file of reviewed, accepted findings "
                         "(default: conf/lint-baseline-torch.json)")
    ln.add_argument("--no-baseline", action="store_true",
                    help="report baselined findings too (review mode)")
    ln.add_argument("--root", metavar="DIR",
                    help="repo root to analyze (default: the tree this "
                         "package was loaded from)")
    ln.set_defaults(fn=cmd_lint)

    vp = sub.add_parser("version")
    vp.set_defaults(fn=lambda a: print(__version__))
    return p


#: verbs whose command path may import torch (the JAX CLI's
#: ``_JAX_VERBS``); every other verb runs on a box without torch, which
#: ``pio lint``'s PL02 checks through the verbs' import closures
_TORCH_VERBS = {"train", "deploy", "eval", "batchpredict", "status", "run",
                "shell", "build"}


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
