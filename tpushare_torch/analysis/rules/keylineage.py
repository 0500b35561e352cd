"""PK: random-generator discipline of the PyTorch port.

The JAX package threads explicit PRNG keys and polices their lineage
(a key drawn from twice, a parent drawn from after its split). A
``torch.Generator`` is stateful: every draw advances it, so drawing
twice from one generator is correct and that class of fault cannot
occur. What replaces it is the question of WHICH state a draw advances:

- **PK501 draw-without-generator** — a ``torch.rand*`` /
  ``multinomial`` / ``bernoulli`` / ``randperm`` / ``normal`` draw, an
  in-place ``normal_`` / ``uniform_`` / ``exponential_`` / ... fill or
  a ``torch.nn.init`` fill in ``models/``, ``ops/`` or ``parallel/``
  without an explicit ``generator=``. It advances the process-global stream instead: the
  sampler's streams stop being reproducible from ``--seed``, and any
  other draw in the process (a tenant, a test, a warm-up) shifts them.
  The serving samplers and ``init_params`` each draw from their own
  ``torch.Generator``; this rule holds every draw to that.
- **PK502 global-seed-in-library** — ``torch.manual_seed`` /
  ``torch.cuda.manual_seed[_all]`` / ``torch.seed`` /
  ``torch.set_rng_state`` in library code resets the process-global
  stream under every other user of it. Seeding belongs to the entry
  point that owns the process (``tools/``, the smoke scripts,
  ``chip_smoke.py``), which this rule leaves alone.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted, last_component
from tpushare_torch.analysis.rules.tracer_safety import TRACER_PATHS

#: torch.* draws that take ``generator=``
TORCH_DRAWS = {"rand", "randn", "randint", "rand_like", "randn_like",
               "randint_like", "multinomial", "bernoulli", "randperm",
               "normal", "poisson"}
#: tensor methods that draw (in-place fills and the method forms)
TENSOR_DRAWS = {"normal_", "uniform_", "exponential_", "bernoulli_",
                "random_", "cauchy_", "log_normal_", "geometric_",
                "multinomial", "bernoulli"}
#: torch.nn.init fills that draw (each takes ``generator=``)
INIT_DRAWS = {"normal_", "uniform_", "trunc_normal_", "xavier_uniform_",
              "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
              "orthogonal_", "sparse_"}
#: calls that reset the process-global stream
GLOBAL_SEEDS = {"torch.manual_seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "torch.random.manual_seed",
                "torch.seed", "torch.cuda.seed", "torch.cuda.seed_all",
                "torch.set_rng_state", "torch.cuda.set_rng_state",
                "torch.cuda.set_rng_state_all"}


def _draw_name(call: ast.Call):
    """The draw's spelling when ``call`` draws random numbers."""
    name = dotted(call.func) or ""
    leaf = last_component(name)
    if name.startswith("torch.") and leaf in TORCH_DRAWS:
        return name
    if ".init." in f".{name}" and leaf in INIT_DRAWS:
        return name
    if isinstance(call.func, ast.Attribute) and call.func.attr in \
            TENSOR_DRAWS and not name.startswith("torch."):
        return f".{call.func.attr}"
    return None


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator"
               and not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
               for kw in call.keywords)


@register
class DrawWithoutGenerator(Rule):
    id = "PK501"
    name = "draw-without-generator"
    family = "generator-discipline"
    description = ("random draw in models/ops/parallel without an "
                   "explicit generator= — it advances the process-"
                   "global stream, so the draws stop following the "
                   "caller's seed and shift under any other user")
    paths = TRACER_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _draw_name(node)
            if name is not None and not _has_generator(node):
                yield ctx.finding(
                    self.id, node,
                    f"{name}() draws from the process-global stream; "
                    f"pass the caller's torch.Generator as generator=")


@register
class GlobalSeedInLibrary(Rule):
    id = "PK502"
    name = "global-seed-in-library"
    family = "generator-discipline"
    description = ("torch.manual_seed / torch.cuda.manual_seed / "
                   "set_rng_state in library code — resets the "
                   "process-global stream under every other user; only "
                   "entry points (tools/, smoke scripts) may seed it")
    paths = ("tpushare_torch/",)

    def applies_to(self, relpath: str) -> bool:
        rp = relpath.replace("\\", "/")
        return (super().applies_to(rp)
                and not rp.startswith("tpushare_torch/tools/")
                and not rp.endswith("smoke.py"))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and dotted(node.func) in GLOBAL_SEEDS):
                yield ctx.finding(
                    self.id, node,
                    f"{dotted(node.func)}() in library code resets the "
                    f"process-global stream; take a torch.Generator "
                    f"from the caller instead")
