"""The port's copy of ``tpushare/utils/ownership.py`` (stdlib only; a test holds it
equal to the original).

Opt-in runtime thread-ownership sanitizer.

The static ownership layer (``tpushare/analysis/threads.py``) proves
what the *declared* contracts imply; this module keeps the
declarations themselves honest. With ``TPUSHARE_OWNERSHIP_CHECKS=1``
(the chaos storm and SLO smoke set it), ``install()`` arms the
declared-owner fields of an object with thread-asserting guards:

- rebinding a guarded field (``obj.field = ...``) from any thread but
  the adopted owner raises :class:`OwnershipViolation`;
- mutating a guarded dict/list field (``obj.field[k] = v``,
  ``.append``, ``.pop``, ``.clear``, ...) likewise, one container
  level deep on both sides (``TierStats._c`` is a dict of dicts);
- reads stay free — the static TO902 rule owns torn-read detection,
  and asserting on reads would serialize the very paths the copies
  exist to keep lock-free.

Ownership transfers by :func:`adopt`: a cell starts unrestricted
(``__init__`` runs on whatever thread constructs the engine), the
engine loop adopts at its top, and the supervisor re-adopts after
joining the dead engine thread — the same serialized-role handover the
``TPUSHARE_OWNERSHIP`` registry declares statically.

When the env var is off (the default, and every production path),
``install``/``adopt`` return immediately: no subclass swap, no
container wrapping, nothing on the tick path.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Optional

ENV = "TPUSHARE_OWNERSHIP_CHECKS"

_CELLS_ATTR = "_tpushare_ownership_cells"
_WRAP_DEPTH = 2


def enabled() -> bool:
    return os.environ.get(ENV) == "1"


class OwnershipViolation(AssertionError):
    """A thread that is not the adopted owner wrote an owned field."""


class _Cell:
    """One guarded field: its declared role and, once adopted, the
    ident of the only thread allowed to write it."""

    __slots__ = ("role", "field", "ident")

    def __init__(self, role: str, field: str):
        self.role = role
        self.field = field
        self.ident: Optional[int] = None

    def adopt(self) -> None:
        self.ident = threading.get_ident()

    def check(self) -> None:
        if self.ident is None:
            return
        me = threading.get_ident()
        if me != self.ident:
            raise OwnershipViolation(
                f"cross-thread write to {self.field}: owned by role "
                f"'{self.role}' on thread {self.ident}, written from "
                f"thread {me} ({threading.current_thread().name})")


class _GuardedDict(dict):
    _tpushare_cell: Optional[_Cell] = None

    def _check(self) -> None:
        if self._tpushare_cell is not None:
            self._tpushare_cell.check()

    def __setitem__(self, k, v):
        self._check()
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._check()
        dict.__delitem__(self, k)

    def pop(self, *a):
        self._check()
        return dict.pop(self, *a)

    def popitem(self):
        self._check()
        return dict.popitem(self)

    def clear(self):
        self._check()
        dict.clear(self)

    def update(self, *a, **kw):
        self._check()
        dict.update(self, *a, **kw)

    def setdefault(self, k, default=None):
        if k not in self:
            self._check()
        return dict.setdefault(self, k, default)


class _GuardedList(list):
    _tpushare_cell: Optional[_Cell] = None

    def _check(self) -> None:
        if self._tpushare_cell is not None:
            self._tpushare_cell.check()

    def __setitem__(self, i, v):
        self._check()
        list.__setitem__(self, i, v)

    def __delitem__(self, i):
        self._check()
        list.__delitem__(self, i)

    def __iadd__(self, other):
        self._check()
        list.extend(self, other)
        return self

    def append(self, v):
        self._check()
        list.append(self, v)

    def extend(self, it):
        self._check()
        list.extend(self, it)

    def insert(self, i, v):
        self._check()
        list.insert(self, i, v)

    def pop(self, *a):
        self._check()
        return list.pop(self, *a)

    def remove(self, v):
        self._check()
        list.remove(self, v)

    def sort(self, **kw):
        self._check()
        list.sort(self, **kw)

    def clear(self):
        self._check()
        list.clear(self)


def _wrap(value, cell: _Cell, depth: int = _WRAP_DEPTH):
    if depth <= 0:
        return value
    if type(value) is dict or type(value) is _GuardedDict:
        g = _GuardedDict({k: _wrap(v, cell, depth - 1)
                          for k, v in value.items()})
        g._tpushare_cell = cell
        return g
    if type(value) is list or type(value) is _GuardedList:
        g = _GuardedList(_wrap(v, cell, depth - 1) for v in value)
        g._tpushare_cell = cell
        return g
    return value


_SUBCLASS_CACHE: Dict[type, type] = {}


def _guarded_subclass(cls: type) -> type:
    sub = _SUBCLASS_CACHE.get(cls)
    if sub is not None:
        return sub

    def __setattr__(self, name, value, _cls=cls):
        cells = self.__dict__.get(_CELLS_ATTR)
        if cells is not None and name in cells:
            cell = cells[name]
            cell.check()
            value = _wrap(value, cell)
        _cls.__setattr__(self, name, value)

    sub = type(cls.__name__, (cls,), {
        "__setattr__": __setattr__,
        "_tpushare_ownership_guarded": True,
    })
    _SUBCLASS_CACHE[cls] = sub
    return sub


def install(obj, role: str, fields: Iterable[str]):
    """Arm ``fields`` of ``obj`` as owned by ``role``. No-op (and no
    wrapper anywhere near the object) unless :func:`enabled`. Call
    from ``__init__`` after the fields exist; writes stay unrestricted
    until a thread :func:`adopt`\\ s the object."""
    if not enabled():
        return obj
    cells = obj.__dict__.setdefault(_CELLS_ATTR, {})
    cname = type(obj).__name__
    for field in fields:
        if field in cells or field not in obj.__dict__:
            continue
        cell = _Cell(role, f"{cname}.{field}")
        cells[field] = cell
        obj.__dict__[field] = _wrap(obj.__dict__[field], cell)
    if not getattr(type(obj), "_tpushare_ownership_guarded", False):
        obj.__class__ = _guarded_subclass(type(obj))
    return obj


def adopt(obj) -> None:
    """Bind every guarded field of ``obj`` to the calling thread —
    the ownership handover (engine-loop start, supervisor takeover
    after join). No-op when checks are off or nothing is armed."""
    if not enabled():
        return
    for cell in obj.__dict__.get(_CELLS_ATTR, {}).values():
        cell.adopt()
