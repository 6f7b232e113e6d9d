"""Static invariant analysis over the port's tree (``pio lint``).

The port's twin of the JAX package's ``analysis`` package: the same
deterministic AST passes, run over ``predictionio_tpu_torch``, with the
rules that have a torch meaning.

========  ==============================================================
``PL01``  trace-safety — serving modules reference no jax, and
          ``*_aot_key`` functions derive keys from geometry only (the
          JAX rule's compile-chain and traced-value sub-checks have no
          torch counterpart and are not ported)
``PL02``  jax-free port, torch-free ops-box verbs — no module imports
          jax, flax, optax or the JAX package at any scope, and verbs
          outside ``tools/cli.py``'s ``_TORCH_VERBS`` must not reach
          ``torch`` through module-scope imports
``PL03``  lock discipline — unlocked writes to attributes a class
          elsewhere guards, blocking calls under a writer lock in the
          data tier, ``open()`` without a context manager in storage
          paths
``PL04``  registry closure — fault sites, Prometheus series, CLI and
          environment flags must each appear in their docs anchor, and
          every fault site must be exercised by a test
``PL05``  resilience hygiene — retries that would swallow deterministic
          4xx rejections, bare ``except:`` on serving paths, 429/503
          responses without a Retry-After hint
========  ==============================================================

Everything here is stdlib-``ast`` only: importing this package (and
running ``pio lint``) imports neither torch nor numpy, so the lint runs
on a box without a card or torch.

Suppression: a finding on line N is silenced by ``# pio-lint:
disable=RULE`` on line N or N-1. Accepted findings live in
``conf/lint-baseline-torch.json`` keyed by the stable
``rule:path:symbol`` key (no line numbers, so unrelated edits never
invalidate an entry); every entry carries a written reason.
"""

from predictionio_tpu_torch.analysis.core import Finding, Project  # noqa: F401
from predictionio_tpu_torch.analysis.runner import RULES, run_lint  # noqa: F401
