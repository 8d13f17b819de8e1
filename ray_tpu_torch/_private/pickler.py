"""The port's function and class pickler: ``pickle`` protocol 5, plus
pickling by value for what a worker cannot import by name.

The JAX package ships remote functions, actor classes and values with
cloudpickle. The port stands on the standard library instead: anything a
worker can import by its module and qualified name is pickled by
reference, as cloudpickle does; a function or class defined in
``__main__`` or inside another function (``<locals>``) is rebuilt from
its code.

By value, a function carries its code object (``marshal``), the globals
its code names, its defaults, closure cells and ``__dict__``; a class
carries its name, bases, metaclass and namespace. Both are rebuilt as a
skeleton first and filled in after, so a recursive function, or a method
that names its own class (``super()``), round-trips. Modules are pickled
by name. Processes of one runtime run one interpreter, so the code
objects ``marshal`` writes are read by the Python that wrote them.
"""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any, Callable, Optional, Set


def _by_reference(obj: Any) -> bool:
    """True if a worker can find ``obj`` as ``module.qualname``."""
    mod = getattr(obj, "__module__", None)
    if mod is None or mod == "__main__":
        return False
    m = sys.modules.get(mod)
    if m is None:
        return False
    found: Any = m
    for part in obj.__qualname__.split("."):
        if part == "<locals>":
            return False
        found = getattr(found, part, None)
        if found is None:
            return False
    return found is obj


# ------------------------------------------------------------ functions

def _code_names(code: types.CodeType) -> Set[str]:
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_names(const)
    return names


def _make_function(code_bytes: bytes, name: str, ncells: int):
    code = marshal.loads(code_bytes)
    cells = tuple(types.CellType() for _ in range(ncells)) or None
    return types.FunctionType(code, {"__builtins__": builtins}, name, None,
                              cells)


def _function_setstate(fn, state: dict) -> None:
    fn.__globals__.update(state["globals"])
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__dict__.update(state["dict"])
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    fn.__doc__ = state["doc"]
    for cell, value in zip(fn.__closure__ or (), state["cells"]):
        if value is not _EMPTY_CELL:
            cell.cell_contents = value


class _EmptyCell:
    def __reduce__(self):
        return "_EMPTY_CELL"


_EMPTY_CELL = _EmptyCell()


def _reduce_function(fn: types.FunctionType):
    code = fn.__code__
    g = fn.__globals__
    globs = {n: g[n] for n in _code_names(code) if n in g}
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(cell.cell_contents)
        except ValueError:
            cells.append(_EMPTY_CELL)
    state = {"globals": globs, "defaults": fn.__defaults__,
             "kwdefaults": fn.__kwdefaults__, "dict": dict(fn.__dict__),
             "qualname": fn.__qualname__, "module": fn.__module__,
             "doc": fn.__doc__, "cells": tuple(cells)}
    return (_make_function,
            (marshal.dumps(code), fn.__name__, len(cells)),
            state, None, None, _function_setstate)


# -------------------------------------------------------------- classes

_SKIP_CLASS_KEYS = frozenset({"__dict__", "__weakref__"})


def _make_class(meta, name: str, bases: tuple, skeleton: dict):
    return types.new_class(name, bases, {"metaclass": meta},
                           lambda ns: ns.update(skeleton))


def _class_setstate(cls, state: dict) -> None:
    for k, v in state.items():
        setattr(cls, k, v)


def _reduce_class(cls: type):
    slots = getattr(cls, "__slots__", ())
    slots = (slots,) if isinstance(slots, str) else tuple(slots)
    skeleton = {"__module__": cls.__module__,
                "__qualname__": cls.__qualname__,
                "__doc__": cls.__doc__}
    if "__slots__" in cls.__dict__:
        skeleton["__slots__"] = slots
    state = {k: v for k, v in cls.__dict__.items()
             if k not in _SKIP_CLASS_KEYS and k not in skeleton
             and k not in slots and not k.startswith("_abc_")}
    return (_make_class,
            (type(cls), cls.__name__, cls.__bases__, skeleton),
            state, None, None, _class_setstate)


# ---------------------------------------------------------------- pickler

class Pickler(pickle.Pickler):
    """``pickle.Pickler`` that pickles unimportable functions and classes
    by value, modules by name, code objects through ``marshal``, and
    method wrappers of either kind."""

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            return NotImplemented if _by_reference(obj) \
                else _reduce_function(obj)
        if isinstance(obj, type):
            if obj.__module__ == "builtins" or _by_reference(obj):
                return NotImplemented
            return _reduce_class(obj)
        if t is types.ModuleType:
            if obj.__name__ == "__main__":
                raise pickle.PicklingError("cannot pickle the __main__ module")
            return importlib.import_module, (obj.__name__,)
        if t in (staticmethod, classmethod):
            return t, (obj.__func__,)
        if t is property:
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        if t is types.MethodType:
            return types.MethodType, (obj.__func__, obj.__self__)
        if t is types.CodeType:   # e.g. a ForwardRef's compiled annotation
            return marshal.loads, (marshal.dumps(obj),)
        return NotImplemented


def dumps(obj: Any, protocol: int = 5,
          buffer_callback: Optional[Callable] = None) -> bytes:
    with io.BytesIO() as f:
        Pickler(f, protocol=protocol, buffer_callback=buffer_callback).dump(obj)
        return f.getvalue()


loads = pickle.loads
