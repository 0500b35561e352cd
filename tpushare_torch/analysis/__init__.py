"""tpushare_torch.analysis — the port's AST static-analysis gate.

The JAX package's gate (``tpushare.analysis``) polices JAX's fault
classes; this is the PyTorch port's own rule set, over the port's tree
and ``chip_smoke.py``. The families:

- TS1xx tracer-safety (models/, ops/, parallel/): host syncs
  (``.item()``, ``.tolist()``, ``.cpu()``, ``.synchronize()``, ...)
  inside autograd scope, and in (and transitively below, via the call
  graph) the engine-tick methods — the one-fetch-per-tick invariant.
- PK5xx generator discipline: random draws off the process-global
  stream, and global reseeding in library code.
- DN601 async copies: a host read of a non_blocking device->host copy
  before it is synchronized.
- JC801 kernel builds reached per call instead of once.
- TE701 tensors escaping autograd scope.
- CC2xx concurrency (plugin/, extender/, k8s/, router/, slo/, durable/
  + serving classes): unlocked cross-thread mutation; blocking calls in
  handlers; swallowed exceptions; lock-order inversion over the
  project-wide lock acquisition graph.
- TO9xx thread ownership over ``# tpushare: owner[...]`` declarations
  and the ``TPUSHARE_OWNERSHIP`` registries.
- RL4xx resource leaks (cli/, models/, ...) and non-atomic persistent
  writes.
- WC3xx wire contract (whole tree): contract string literals outside
  plugin/const.py; proto field drift vs deviceplugin/api.proto; the
  HTTP serving plane's consumed keys, endpoints and null-not-zero
  contract.

The inter-procedural rules ride on tpushare_torch.analysis.callgraph: a
project call graph with per-function summaries (syncs host, lock and
resource acquire/release, may raise) propagated over resolved call
chains, cached per file mtime.

Run ``python -m tpushare_torch.analysis --check`` for the ratcheted
gate (exit 1 = new findings, exit 2 = stale baseline entries to prune),
``--check --diff origin/main`` for changed files only (the call graph
stays project-wide), ``--format sarif`` for the code-scanning format, or bare
for a full informational listing. Suppressions keep the JAX package's
spelling (``# tpushare: ignore[RULE]``). Imports nothing but the
standard library: the gate runs on any host that can parse Python, and
never needs the card.
"""

from tpushare_torch.analysis.config import AnalysisConfig, load_config  # noqa: F401
from tpushare_torch.analysis.engine import (  # noqa: F401
    Finding, Rule, all_rules, analyze_file, analyze_paths, register,
)
