"""Multi-model serving: resident variant sets on one replica (the port's
copy of the JAX package's ``server/variants.py``).

Upstream PredictionIO's engine-variant A/B story (``pio eval``, engine
variants — PAPER.md survey §0) is offline-only: one deployed process
serves exactly one model. This module makes several model GENERATIONS
(champion / challenger / canary, from the model registry) resident on
ONE serving replica at once, every arm's factors resident on the
server's device, each arm with its own AOT bucket ladder warmed through
the process-wide executable cache — so multiplexing is a dispatch
problem, not a build problem: same-geometry arms share every serving
program (its buffers and the ``score_topk`` kernel), and each dispatch
passes its own arm's factors to it.

Dispatch is a **deterministic weighted split**: each query's entity is
hashed with a salt and walked through the cumulative weights, so a user
sticks to their assigned arm for as long as the weights stand (sticky
assignment — the property online metrics need: a user's feedback accrues
against the variant that actually served them). Weights are editable at
runtime (``POST /variants/weights``, ``pio variants set-weights``) with
probe-then-apply semantics: a weight can only be put on a variant that
is resident AND warmed.

Failure containment: a variant whose ``/reload`` swap dies mid-flight
(fault site ``variant.reload.partial``) is marked failed and drops out
of the effective split — the default arm (champion) absorbs its weight
and keeps serving. The default arm itself rolls back like the classic
single-model ``/reload``: the last-good engine is retained.

Fault sites (utils/faults.py Known-sites table):

- ``variant.assign.skew``   — assignment hash bypassed; every query
  lands on the default arm (a skewed split the chaos harness must see)
- ``variant.reload.partial`` — a variant swap dies after the candidate
  loaded but before it published (mid-swap kill)
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.utils import faults

#: variant names: dns-label-ish, so they are safe in headers,
#: Prometheus label values, and CLI specs
_NAME = re.compile(r"^[a-z0-9][a-z0-9_-]*$")

#: reserved names with registry-resolution semantics
CHAMPION = "champion"


class VariantError(ValueError):
    """Bad variant spec / weights / unknown variant."""


@dataclass
class VariantSpec:
    """One arm of the split, as configured (``name[@gen]:weight``)."""

    name: str
    weight: float
    gen: Optional[int] = None  # pinned registry generation


@dataclass
class ResidentVariant:
    """One arm of the split, as loaded on the serving device."""

    spec: VariantSpec
    gen: Optional[int] = None
    instance_id: Optional[str] = None
    deployed: Any = None
    warmup: Any = None          # per-variant AOTWarmup (or None)
    state: str = "loading"      # loading | ready | failed
    error: Optional[str] = None
    swapped_at: float = 0.0
    swaps: int = 0

    def serving(self) -> bool:
        return self.state == "ready" and self.deployed is not None


def parse_weights(spec: str) -> List[VariantSpec]:
    """Parse a split spec: comma-separated ``name[@gen]:weight`` arms
    (``=`` accepted for ``:``), e.g. ``champion:9,challenger:1`` or
    ``champion@3:90,canary@5:10``. Order matters: the FIRST arm is the
    default — it absorbs the weight of failed arms and is where the
    ``variant.assign.skew`` drill lands all traffic.
    """
    out: List[VariantSpec] = []
    seen = set()
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(?P<name>[^@:=]+)(?:@(?P<gen>\d+))?[:=]"
                     r"(?P<w>[0-9.]+)$", part)
        if not m:
            raise VariantError(
                f"bad variant spec {part!r} (want name[@gen]:weight)")
        name = m.group("name").strip()
        if not _NAME.match(name):
            raise VariantError(f"bad variant name {name!r}")
        if name in seen:
            raise VariantError(f"duplicate variant {name!r}")
        seen.add(name)
        try:
            w = float(m.group("w"))
        except ValueError:
            raise VariantError(f"bad weight in {part!r}") from None
        if w < 0:
            raise VariantError(f"negative weight in {part!r}")
        out.append(VariantSpec(
            name=name, weight=w,
            gen=int(m.group("gen")) if m.group("gen") else None))
    if not out:
        raise VariantError("empty variant spec")
    if sum(v.weight for v in out) <= 0:
        raise VariantError("variant weights sum to zero")
    return out


def weighted_assign(entity: str, arms: List[Tuple[str, float]],
                    salt: str = "pio") -> str:
    """Deterministic sticky assignment: hash (salt, entity) into [0, 1)
    and walk the cumulative weights. Pure: the CLI previews splits with
    the exact function serving uses, and both packages assign every
    entity alike.
    """
    total = sum(w for _, w in arms)
    if total <= 0 or not arms:
        raise VariantError("no arms with positive weight")
    digest = hashlib.sha256(
        f"{salt}|{entity}".encode("utf-8")).digest()
    x = int.from_bytes(digest[:8], "big") / float(1 << 64)
    acc = 0.0
    for name, w in arms:
        acc += w / total
        if x < acc:
            return name
    return arms[-1][0]  # float rounding: last arm catches the tail


def entity_of(query: Any) -> str:
    """The split key for one query: the entity the query is ABOUT, so
    one user's requests stick to one arm. Falls back to the canonical
    JSON of the whole query (still deterministic, just per-shape)."""
    if isinstance(query, dict):
        for key in ("user", "uid", "entity", "entityId", "item", "id"):
            v = query.get(key)
            if v is not None:
                return str(v)
    try:
        return json.dumps(query, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return str(query)


class VariantSet:
    """The resident variant set of one serving replica.

    Resolution: each arm names a model generation in the
    ``ModelRegistry`` — ``champion`` is the registry champion,
    ``name@N`` pins generation N, and any other unpinned name resolves
    to the NEWEST non-champion generation (the natural challenger).
    Loading the default (first) arm must succeed; any other arm that
    fails to load or warm is marked failed and excluded from the
    effective split, its weight folding into the default arm.
    """

    def __init__(self, storage: Any, specs: Any,
                 engine_factory: Optional[str] = None,
                 variant_id: str = "",
                 salt: str = "pio",
                 warm_factory: Optional[Callable[[], Any]] = None,
                 prepare: Optional[Callable[[str], Any]] = None,
                 device: Any = None) -> None:
        self.storage = storage
        self.specs: List[VariantSpec] = (
            parse_weights(specs) if isinstance(specs, str) else list(specs))
        self.engine_factory = engine_factory
        self.variant_id = variant_id
        self.salt = salt
        #: every arm loads on this device (the server's), never elsewhere
        self.device = device
        self._warm_factory = warm_factory
        self._prepare = prepare or self._prepare_default
        self._registry: Any = None
        self._lock = threading.Lock()
        self.weights_epoch = 0
        self._variants: Dict[str, ResidentVariant] = {
            s.name: ResidentVariant(spec=s) for s in self.specs}

    # -- resolution / loading ----------------------------------------------

    @property
    def default(self) -> str:
        """The first configured arm — champion by convention."""
        return self.specs[0].name

    def names(self) -> List[str]:
        return [s.name for s in self.specs]

    def get(self, name: str) -> ResidentVariant:
        try:
            return self._variants[name]
        except KeyError:
            raise VariantError(f"unknown variant {name!r}") from None

    def registry(self) -> Any:
        if self._registry is None:
            from predictionio_tpu_torch.storage.models import model_registry

            self._registry = model_registry(self.storage)
        return self._registry

    def resolve(self, spec: VariantSpec) -> Tuple[int, str]:
        """Map one arm to a (generation, instance_id) in the registry."""
        reg = self.registry()
        entries = {e["gen"]: e for e in reg.generations()}
        if not entries:
            raise VariantError("model registry is empty")
        if spec.gen is not None:
            e = entries.get(spec.gen)
            if e is None:
                raise VariantError(
                    f"variant {spec.name!r} pins gen-{spec.gen:06d} "
                    "which is not in the registry")
            return e["gen"], e["instance_id"]
        champ = reg.champion()
        if spec.name == CHAMPION:
            if champ is None:
                raise VariantError("registry has no champion")
            return champ["gen"], champ["instance_id"]
        # unpinned non-champion arm: newest generation that is not the
        # champion and was not judged off the board
        champ_gen = champ["gen"] if champ else None
        live = [g for g, e in entries.items()
                if g != champ_gen
                and e.get("status") not in ("retired", "rolled_back")]
        if not live:
            raise VariantError(
                f"variant {spec.name!r}: no non-champion generation "
                "to serve as challenger")
        g = max(live)
        return g, entries[g]["instance_id"]

    def _prepare_default(self, instance_id: str) -> Any:
        from predictionio_tpu_torch.core.workflow import prepare_deploy

        return prepare_deploy(
            engine_factory=self.engine_factory, instance_id=instance_id,
            storage=self.storage, variant_id=self.variant_id,
            device=self.device)

    def _load_one(self, rv: ResidentVariant) -> None:
        gen, iid = self.resolve(rv.spec)
        deployed = self._prepare(iid)
        if self._warm_factory is not None and rv.warmup is None:
            rv.warmup = self._warm_factory()
        with self._lock:
            rv.gen, rv.instance_id = gen, iid
            rv.deployed = deployed
            rv.state = "ready"
            rv.error = None
            rv.swapped_at = time.time()

    def load(self) -> None:
        """Load every arm. The default arm must load — its error
        propagates; any other arm that fails is marked failed (its
        weight folds into the default arm) and serving proceeds."""
        for spec in self.specs:
            rv = self._variants[spec.name]
            try:
                self._load_one(rv)
            except Exception as e:
                if spec.name == self.default:
                    raise
                with self._lock:
                    rv.state = "failed"
                    rv.error = f"{type(e).__name__}: {e}"

    def start_warmups(self) -> None:
        """Kick each loaded arm's AOT warmup in the background (the same
        contract as the single-model deploy-time warmup). The first arm
        warms first and the others one after another once it is done,
        so that arms of its geometry adopt its cached programs instead
        of racing it to build them; an arm not yet started reads as
        ``idle``, which :meth:`warm_state` counts as warming."""
        arms = [rv for rv in self._variants.values()
                if rv.warmup is not None and rv.serving()]
        if not arms:
            return
        arms[0].warmup.start(arms[0].deployed)
        if len(arms) == 1:
            return

        def rest() -> None:
            arms[0].warmup.wait()
            for rv in arms[1:]:
                rv.warmup.start(rv.deployed)
                rv.warmup.wait()

        threading.Thread(target=rest, name="pio-variant-warmups",
                         daemon=True).start()

    def warm_sync_all(self) -> None:
        """Warm every loaded arm synchronously (tests/harness)."""
        for rv in self._variants.values():
            if rv.warmup is not None and rv.serving():
                rv.warmup.warm_sync(rv.deployed)
                rv.warmup.mark_ready()

    def warm_state(self) -> str:
        """Aggregate AOT state over SERVING arms: ``warming`` while any
        ladder still warms, ``failed`` if any warmup failed (unwarmed
        shapes build on first use — degraded, not down), else
        ``ready``."""
        states = [rv.warmup.state for rv in self._variants.values()
                  if rv.warmup is not None and rv.serving()]
        if any(s in ("idle", "warming") for s in states):
            return "warming"
        if any(s == "failed" for s in states):
            return "failed"
        return "ready"

    # -- the split ----------------------------------------------------------

    def effective_weights(self) -> List[Tuple[str, float]]:
        """Configured weights over SERVING arms only — a failed or
        still-loading arm's weight lands on the default arm, so losing
        the challenger means a 100/0 split, never an error."""
        arms: List[Tuple[str, float]] = []
        orphaned = 0.0
        for spec in self.specs:
            rv = self._variants[spec.name]
            if rv.serving():
                arms.append((spec.name, spec.weight))
            else:
                orphaned += spec.weight
        if not arms:
            return []
        if orphaned > 0:
            arms = [(n, w + orphaned) if n == self.default else (n, w)
                    for n, w in arms]
        return arms

    def choose(self, entity: str, override: Optional[str] = None) -> str:
        """Pick the serving arm for one query. ``override`` is the
        ``X-PIO-Variant`` request header — it must name a SERVING arm.
        """
        if override:
            rv = self._variants.get(override)
            if rv is None or not rv.serving():
                raise VariantError(
                    f"variant {override!r} is not resident and serving")
            return override
        try:
            # chaos drill: an armed error here bypasses the hash — all
            # traffic piles onto the default arm (a visible skew)
            faults.inject("variant.assign.skew")
        except faults.FaultError:
            return self.default
        arms = self.effective_weights()
        if not arms:
            raise VariantError("no serving variants")
        return weighted_assign(entity, arms, self.salt)

    def set_weights(self, weights: Dict[str, float]) -> List[Tuple[str, float]]:
        """Probe-then-apply: every named arm must be resident AND
        serving before any weight moves. Returns the new effective
        split. Arms not named keep weight 0 (an explicit retire)."""
        if not weights:
            raise VariantError("empty weights")
        parsed: Dict[str, float] = {}
        for name, w in weights.items():
            rv = self._variants.get(name)
            if rv is None:
                raise VariantError(f"unknown variant {name!r}")
            if not rv.serving():
                raise VariantError(
                    f"variant {name!r} is {rv.state}, not serving — "
                    "refusing to weight it")
            w = float(w)
            if w < 0:
                raise VariantError(f"negative weight for {name!r}")
            parsed[name] = w
        if sum(parsed.values()) <= 0:
            raise VariantError("weights sum to zero")
        with self._lock:
            for spec in self.specs:
                spec.weight = parsed.get(spec.name, 0.0)
            self.weights_epoch += 1
        return self.effective_weights()

    # -- reload -------------------------------------------------------------

    def reload_variant(self, name: str,
                       probe: Optional[Callable[[Any], None]] = None,
                       ) -> Dict[str, Any]:
        """Swap ONE arm onto its freshly-resolved generation, leaving
        every other arm untouched. Runs load → (fault site) → warm →
        probe → publish; the swap is the last step, so a candidate
        that dies anywhere earlier never serves.

        Outcomes: ``promoted`` (swap landed); ``rolled_back`` (default
        arm kept its last-good engine); ``failed`` (a non-default arm
        dropped out of the split — the champion absorbs its weight).
        """
        rv = self.get(name)
        old = (rv.gen, rv.instance_id, rv.deployed, rv.state, rv.error)
        try:
            gen, iid = self.resolve(rv.spec)
            deployed = self._prepare(iid)
            # mid-swap kill site: the candidate is loaded but has not
            # published — a crash here must strand NOTHING in the split
            faults.inject("variant.reload.partial")
            if self._warm_factory is not None and rv.warmup is None:
                rv.warmup = self._warm_factory()
            if rv.warmup is not None:
                rv.warmup.warm_sync(deployed)
                rv.warmup.mark_ready()
            if probe is not None:
                probe(deployed)
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            if name == self.default and old[2] is not None:
                # champion semantics: last-good engine keeps serving
                return {"variant": name, "outcome": "rolled_back",
                        "generation": old[0], "error": err}
            with self._lock:
                rv.deployed = None
                rv.state = "failed"
                rv.error = err
            return {"variant": name, "outcome": "failed",
                    "generation": old[0], "error": err}
        with self._lock:
            rv.gen, rv.instance_id = gen, iid
            rv.deployed = deployed
            rv.state = "ready"
            rv.error = None
            rv.swapped_at = time.time()
            rv.swaps += 1
        return {"variant": name, "outcome": "promoted", "generation": gen,
                "engineInstanceId": iid}

    # -- observability ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The /health + /variants view: per-arm generation, warmup
        state, configured and effective weights."""
        eff = dict(self.effective_weights())
        total = sum(eff.values()) or 1.0
        variants: Dict[str, Any] = {}
        for spec in self.specs:
            rv = self._variants[spec.name]
            variants[spec.name] = {
                "generation": rv.gen,
                "engineInstanceId": rv.instance_id,
                "state": rv.state,
                "weight": spec.weight,
                "effectiveWeight": round(eff.get(spec.name, 0.0) / total, 6),
                "warmup": (rv.warmup.progress()
                           if rv.warmup is not None else None),
                "swappedAt": round(rv.swapped_at, 3) or None,
                "swaps": rv.swaps,
                "error": rv.error,
            }
        return {"salt": self.salt, "default": self.default,
                "weightsEpoch": self.weights_epoch, "variants": variants}
