"""DN601: host read of an asynchronous device->host copy before it is done.

The JAX package's donation rules guard one fault: reading a buffer
whose contents the device no longer vouches for (read-after-donate).
The port donates nothing, but it has the dual: a copy from the card
into page-locked host memory with ``non_blocking=True`` returns before
the bytes arrive. The destination is garbage until the copy's stream
(or an event recorded after it) is synchronized, and reading it early
returns stale or half-written values with no error — on the CPU, where
the tests run, the copy is synchronous and the bug never shows.

A host buffer enters the in-flight state at
``x = t.to("cpu", non_blocking=True)`` / ``t.cpu(non_blocking=True)``,
or at ``dst.copy_(src, non_blocking=True)`` where ``dst`` was made in
page-locked memory in this function (``torch.empty(...,
pin_memory=...)`` and friends, ``t.pin_memory()``). Any
``.synchronize()`` (an event, a stream, ``torch.cuda.synchronize``)
ends every in-flight copy. In between, a data read — ``.tolist()``,
``.numpy()``, ``.item()`` (of the buffer or an element of it),
``np.asarray(x)``, ``bytes(x)`` — is the finding. Handing the buffer
off (returning it with its event, storing it) is not a read: the
receiver's wait is its own business.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from tpushare_torch.analysis import dataflow
from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted, last_component

DN_PATHS = ("tpushare_torch/",)

#: factories whose ``pin_memory=`` result is page-locked host memory
PINNED_FACTORIES = {"empty", "zeros", "ones", "full", "empty_like",
                    "zeros_like", "ones_like", "full_like", "tensor",
                    "empty_strided"}
#: tensor methods that read the buffer's data on the host
READ_METHODS = {"tolist", "numpy", "item", "clone", "sum", "max", "min",
                "any", "all", "argmax", "nonzero", "equal", "tobytes",
                "__array__"}
#: functions that read their argument's data on the host
READ_FUNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "bytes", "memoryview", "float", "int", "bool", "list",
              "torch.equal"}


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking"
               and not (isinstance(kw.value, ast.Constant)
                        and not kw.value.value)
               for kw in call.keywords)


def _to_host_async(call: ast.Call) -> bool:
    """``t.to("cpu", non_blocking=True)`` / ``t.cpu(non_blocking=True)``."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and _non_blocking(call)):
        return False
    if func.attr == "cpu":
        return True
    if func.attr != "to":
        return False
    dev = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "device"), None)
    return isinstance(dev, ast.Constant) and dev.value == "cpu"


def _pinned_alloc(call: ast.Call) -> bool:
    name = dotted(call.func) or ""
    if isinstance(call.func, ast.Attribute) and call.func.attr == \
            "pin_memory":
        return True
    return (name.startswith("torch.")
            and last_component(name) in PINNED_FACTORIES
            and any(kw.arg == "pin_memory" for kw in call.keywords))


class _CopyDomain(dataflow.Domain):
    def _place(self, env, node) -> Optional[str]:
        while isinstance(node, ast.Subscript):
            node = node.value           # x[i] reads x's bytes
        if isinstance(node, ast.Name):
            root, _ = env.resolve(node.id)
            return root
        name = dotted(node)
        if name and name.startswith("self.") and name.count(".") == 1:
            return name
        return None

    def _read(self, env, node, how: str) -> None:
        place = self._place(env, node)
        if place is None:
            return
        v = env.get(place)
        if v is not None and v.tag == "inflight":
            self.emit("DN601", node,
                      f"{how} reads host buffer {dotted(node) or place!r} "
                      f"while its non_blocking copy from line {v.line} "
                      f"may still be in flight — synchronize the copy's "
                      f"event or stream first")

    def on_call(self, env, call, walker):
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "synchronize":
            for place, v in list(env.v.items()):
                if v is not None and v.tag == "inflight":
                    env.bind(place, dataflow.Value("pinned",
                                                   line=call.lineno))
            return None
        if _to_host_async(call):
            return dataflow.Value("inflight", line=call.lineno)
        if _pinned_alloc(call):
            return dataflow.Value("pinned", line=call.lineno)
        if isinstance(func, ast.Attribute):
            if func.attr == "copy_" and _non_blocking(call):
                place = self._place(env, func.value)
                v = env.get(place) if place else None
                if v is not None and v.tag in ("pinned", "inflight"):
                    env.bind(place, dataflow.Value("inflight",
                                                   line=call.lineno))
                return None
            if func.attr in READ_METHODS:
                self._read(env, func.value, f".{func.attr}()")
                return None
        name = dotted(func)
        if name in READ_FUNCS and call.args:
            self._read(env, call.args[0], f"{name}()")
        return None

    def join(self, a, b):
        if a == b:
            return a
        for v in (a, b):
            if v is not None and v.tag == "inflight":
                return v        # in flight on either path: wait first
        if (a is not None and b is not None and a.tag == b.tag
                and a.tag in ("alias", "pinned")):
            return a if a.data == b.data else None
        return None


@register
class ReadBeforeCopyReady(Rule):
    id = "DN601"
    name = "host-read-before-copy-ready"
    family = "async-copy"
    description = ("host read of a page-locked buffer filled by a "
                   "non_blocking device->host copy before any "
                   ".synchronize() — the bytes may not have arrived; "
                   "on the CPU the copy is synchronous and hides it")
    paths = DN_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if "non_blocking" not in ctx.source:
            return      # cheap gate: no async copy, no flow walk
        for cls_name, fn in dataflow.iter_functions(ctx.tree):
            if not dataflow.resolvable(fn):
                continue
            domain = _CopyDomain(self, ctx, class_name=cls_name)
            yield from dataflow.FlowWalker(domain).run(fn)
