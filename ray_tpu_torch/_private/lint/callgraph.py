"""Whole-program call graph over ``Project`` with fixed-point function
summaries.

The graph resolves, import-aware and cross-module:

- bare-name calls to module functions (``helper()``),
- ``mod.helper()`` / ``pkg.mod.helper()`` through ``import`` /
  ``from .. import`` (aliases included),
- ``self.meth()`` through the enclosing class and its project-resolvable
  bases,
- ``self._attr.meth()`` through receiver-type inference — ``self._attr``
  assignments of the form ``self._attr = SomeClass(...)`` (including
  dict/list literals of constructed values, for metric tables) and
  annotations give the attribute a set of candidate classes,
- ``obj.meth()`` where ``obj`` is a parameter with a project-class
  annotation or a local ``obj = SomeClass(...)`` assignment,
- ``self._cb()`` where ``self._cb = self.meth`` (bound-method stashing).

On top of the graph a cycle-safe fixed point computes, per function, the
set of *items* transitively reachable from its body:

- ``("block", name)``       — a thread-blocking op (sleep / RPC /
                              subprocess / socket / future wait),
- ``("unbounded", name)``   — a wait with no timeout,
- ``("unbounded?", name, p)`` — a wait bounded ONLY IF the caller passes
                              parameter ``p`` (bounds propagate through
                              call sites: passing a literal bound
                              discharges the item, passing ``None`` or
                              omitting a ``None``-default makes it
                              definite, forwarding one's own parameter
                              re-conditions it),
- ``("lock", lock_id)``     — a lock acquired via ``with``.

Every item carries a witness chain (call site per hop, op site at the
end) so findings can show the path, not just the endpoints. Propagation
is monotone over finite item sets, so cycles (recursion) terminate
naturally; ``depth=`` bounds the number of propagation rounds (depth 1 =
one call deep, the pre-callgraph behavior; ``None`` = full fixed point).

Async boundaries: an ``async def``'s items never leak into a sync caller
(calling a coroutine function only creates the coroutine), and an async
caller inherits from an async callee only when the call is awaited.
Items under an ``await`` are skipped entirely — awaiting is the correct
way to wait on a loop.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch._private.lint.core import (
    Project,
    Source,
    call_name,
    has_kw,
    unparse,
    walk_calls,
)

# FuncId: (module, class, function); class == "" for module-level defs.
FuncId = Tuple[str, str, str]

Item = tuple  # ("block", name) | ("unbounded", name) | ("unbounded?", name, p) | ("lock", lid)


def fid_str(fid: FuncId) -> str:
    mod, cls, fn = fid
    return f"{mod}.{cls}.{fn}" if cls else f"{mod}.{fn}"


# ------------------------------------------------------- op classification
# Shared by the checkers: one vocabulary of blocking / waiting ops.

# A blocking object get, bounded only by a timeout: the runtime module's,
# and the runtime seam's (the gang and serving paths hold their runtime
# as ``self._rt`` / ``self._runtime`` or take it as ``rt`` / ``runtime``).
GET_NAMES = frozenset({"ray.get", "ray_tpu_torch.get", "rt.get",
                       "runtime.get", "self._rt.get", "self._runtime.get"})
BLOCKING_EXACT = {"time.sleep", "socket.create_connection"} | GET_NAMES
BLOCKING_LEAVES = {"request", "communicate", "wait", "join", "result",
                   "sendall", "connect", "recv", "recv_into", "accept",
                   "wait_for", "run", "check_call", "check_output",
                   "Popen"}
# `.run(...)`/`.check_*` only count when the receiver smells like
# subprocess territory, to keep dict-ish and domain `.run()` out.
NEEDS_RECEIVER_HINT = {"run", "check_call", "check_output"}
RECEIVER_HINT = re.compile(r"subprocess")

ZERO_ARG_WAITERS = {"wait", "result", "join"}
QUEUE_HINTS = ("queue", "inbox", "mailbox")
TIMEOUT_KWS = ("timeout", "timeout_s", "timeout_ms", "deadline",
               "timeout_seconds")


def literal_receiver(call: ast.Call) -> bool:
    """``"sep".join(...)`` / ``b"".join(...)``: a str or bytes literal's
    method, never a thread's or a process's."""
    return isinstance(call.func, ast.Attribute) and \
        isinstance(call.func.value, ast.Constant) and \
        isinstance(call.func.value.value, (str, bytes))


def blocking_name(call: ast.Call) -> Optional[str]:
    """Dotted name if this call can block a thread, else None."""
    name = call_name(call)
    if name in BLOCKING_EXACT:
        return name
    head, _, leaf = name.rpartition(".")
    if leaf in BLOCKING_LEAVES and head:
        if leaf in NEEDS_RECEIVER_HINT and not RECEIVER_HINT.search(head):
            return None
        if leaf == "join" and (head.endswith("path")
                               or len(call.args) > 1
                               or literal_receiver(call)):
            return None  # os.path.join / str.join, not thread.join
        return name
    if name == "Popen":
        return name
    return None


def bounded_channels(src: Source) -> set:
    """Leaf names bound to a _GcsChannel in this file (the channel
    applies a default RPC bound) — small aliasing fixpoint."""
    assigns = [n for n in ast.walk(src.tree) if isinstance(n, ast.Assign)]
    names: set = set()

    def _leaf(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    for a in assigns:
        if isinstance(a.value, ast.Call) and \
                call_name(a.value).rsplit(".", 1)[-1] == "_GcsChannel":
            names.update(filter(None, (_leaf(t) for t in a.targets)))
    for _ in range(3):
        grew = False
        for a in assigns:
            lv = _leaf(a.value) if isinstance(
                a.value, (ast.Name, ast.Attribute)) else None
            if lv in names:
                for t in a.targets:
                    lt = _leaf(t)
                    if lt and lt not in names:
                        names.add(lt)
                        grew = True
        if not grew:
            break
    return names


# ------------------------------------------------------------- graph model

class FuncInfo:
    __slots__ = ("fid", "src", "node", "is_async", "params", "defaults",
                 "kwonly", "has_varkw")

    def __init__(self, fid: FuncId, src: Source, node: ast.AST):
        self.fid = fid
        self.src = src
        self.node = node
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        a = node.args
        self.params = [p.arg for p in a.posonlyargs + a.args]
        self.kwonly = [p.arg for p in a.kwonlyargs]
        self.has_varkw = a.kwarg is not None
        # param -> default expr; absent key = required.
        self.defaults: Dict[str, ast.AST] = {}
        pos_defaults = a.defaults
        if pos_defaults:
            for p, d in zip(self.params[-len(pos_defaults):], pos_defaults):
                self.defaults[p] = d
        for p, d in zip(self.kwonly, a.kw_defaults):
            if d is not None:
                self.defaults[p] = d


class Edge:
    __slots__ = ("caller", "callee", "call", "line", "awaited", "offset",
                 "src")

    def __init__(self, caller: FuncId, callee: FuncId, call: ast.Call,
                 line: int, awaited: bool, offset: int, src: Source):
        self.caller = caller
        self.callee = callee
        self.call = call
        self.line = line
        self.awaited = awaited
        self.offset = offset
        self.src = src


class CallGraph:
    """Indices + resolution + summaries. Built once per Project."""

    def __init__(self, project: Project, depth: Optional[int] = None):
        self.project = project
        self.depth = depth
        self.functions: Dict[FuncId, FuncInfo] = {}
        self.modules: Dict[str, Source] = {}
        self._canon: Dict[str, str] = {}         # src.modname -> canonical
        self._imports_mod: Dict[str, Dict[str, str]] = {}   # alias -> module
        self._imports_sym: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._plain_imports: Dict[str, Set[str]] = {}        # dotted names
        self._classes: Dict[Tuple[str, str], ast.ClassDef] = {}
        self._class_src: Dict[Tuple[str, str], Source] = {}
        self._bases: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        self._attr_types: Dict[Tuple[str, str],
                               Dict[str, Set[Tuple[str, str]]]] = {}
        self._attr_methods: Dict[Tuple[str, str], Dict[str, FuncId]] = {}
        self._fid_of_node: Dict[int, FuncId] = {}
        self._local_types_cache: Dict[int, Dict[str, Set[Tuple[str, str]]]] = {}
        self._module_var_cache: Dict[str, Dict[str, Set[Tuple[str, str]]]] = {}
        self._edges: Optional[Dict[FuncId, List[Edge]]] = None
        self._sum: Optional[Dict[FuncId, Set[Item]]] = None
        self._wit: Dict[Tuple[FuncId, Item], tuple] = {}
        self._lock_graph: Optional[Dict[Tuple[str, str], tuple]] = None
        self._self_nests: Optional[List[tuple]] = None
        self._hot_locks: Optional[Dict[str, tuple]] = None
        self._build_indices()

    # ------------------------------------------------------------ indices

    @staticmethod
    def canonical(modname: str) -> str:
        return modname[:-9] if modname.endswith(".__init__") else modname

    def _build_indices(self) -> None:
        for src in self.project.sources:
            mod = self.canonical(src.modname)
            self._canon[src.modname] = mod
            self.modules.setdefault(mod, src)
        for src in self.project.sources:
            mod = self.canonical(src.modname)
            is_pkg = src.rel.endswith("__init__.py")
            imods: Dict[str, str] = {}
            isyms: Dict[str, Tuple[str, str]] = {}
            plain: Set[str] = set()
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.asname:
                            imods[alias.asname] = alias.name
                        else:
                            plain.add(alias.name)
                elif isinstance(node, ast.ImportFrom):
                    base = mod
                    if node.level:
                        parts = mod.split(".")
                        # level 1 = the containing package.
                        drop = node.level - (1 if is_pkg else 0)
                        if drop > 0:
                            parts = parts[:-drop] if drop < len(parts) else []
                        base = ".".join(parts)
                    target = f"{base}.{node.module}" if node.module else base
                    if node.level == 0:
                        target = node.module or ""
                    for alias in node.names:
                        if alias.name == "*":
                            continue
                        local = alias.asname or alias.name
                        isyms[local] = (target, alias.name)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    if isinstance(src.parent(node), ast.Module):
                        fid = (mod, "", node.name)
                        self.functions[fid] = FuncInfo(fid, src, node)
                        self._fid_of_node[id(node)] = fid
                elif isinstance(node, ast.ClassDef):
                    if not isinstance(src.parent(node), ast.Module):
                        continue
                    ckey = (mod, node.name)
                    self._classes[ckey] = node
                    self._class_src[ckey] = src
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            fid = (mod, node.name, item.name)
                            self.functions[fid] = FuncInfo(fid, src, item)
                            self._fid_of_node[id(item)] = fid
            self._imports_mod[mod] = imods
            self._imports_sym[mod] = isyms
            self._plain_imports[mod] = plain

        # Base classes + attribute types need the import maps, so: pass 2.
        for ckey, cnode in self._classes.items():
            mod, _ = ckey
            src = self._class_src[ckey]
            bases: List[Tuple[str, str]] = []
            for b in cnode.bases:
                t = self._resolve_type_expr(b, mod)
                if t is not None:
                    bases.append(t)
            self._bases[ckey] = bases
            atypes: Dict[str, Set[Tuple[str, str]]] = {}
            amethods: Dict[str, FuncId] = {}
            for sub in ast.walk(cnode):
                attr, val = None, None
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        attr, val = tgt.attr, sub.value
                    elif isinstance(tgt, ast.Name) and \
                            src.parent(sub) is cnode:
                        attr, val = tgt.id, sub.value
                elif isinstance(sub, ast.AnnAssign):
                    tgt = sub.target
                    name = None
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        name = tgt.attr
                    elif isinstance(tgt, ast.Name):
                        name = tgt.id
                    if name:
                        t = self._resolve_type_expr(sub.annotation, mod)
                        if t is not None:
                            atypes.setdefault(name, set()).add(t)
                    continue
                if attr is None:
                    continue
                for v in self._ctor_values(val):
                    t = self._value_type(v, mod)
                    if t is not None:
                        atypes.setdefault(attr, set()).add(t)
                if isinstance(val, ast.Name):
                    # ``self._w = worker`` where ``worker`` is an
                    # annotated parameter of the enclosing method.
                    fn = src.enclosing_function(sub)
                    if fn is not None:
                        a = fn.args
                        for p in (a.posonlyargs + a.args + a.kwonlyargs):
                            if p.arg == val.id and \
                                    p.annotation is not None:
                                t = self._resolve_type_expr(
                                    p.annotation, mod)
                                if t is not None:
                                    atypes.setdefault(
                                        attr, set()).add(t)
                if isinstance(val, ast.Attribute) and \
                        isinstance(val.value, ast.Name) and \
                        val.value.id == "self":
                    # self._cb = self.meth: bound-method stashing.
                    m = self._lookup_method(ckey, val.attr)
                    if m is not None:
                        amethods[attr] = m
            self._attr_types[ckey] = atypes
            self._attr_methods[ckey] = amethods

    @staticmethod
    def _ctor_values(val: ast.AST) -> Iterable[ast.AST]:
        """The value expr(s) whose type an attribute assignment implies —
        dict/list literals of constructed values type the elements (for
        ``self._m = {"shed": Counter(...)}`` metric tables)."""
        if isinstance(val, ast.Dict):
            return list(val.values)
        if isinstance(val, (ast.List, ast.Tuple)):
            return list(val.elts)
        return [val]

    def _value_type(self, val: ast.AST,
                    mod: str) -> Optional[Tuple[str, str]]:
        if isinstance(val, ast.Call):
            t = self._resolve_type_expr(val.func, mod)
            if t is not None:
                return t
            # f() where f is a project function with a return
            # annotation: the annotation is the type.
            fid = self._callee_by_name(val.func, mod)
            info = self.functions.get(fid) if fid else None
            ret = getattr(info.node, "returns", None) if info else None
            if ret is not None:
                return self._resolve_type_expr(
                    ret, self.canonical(info.src.modname))
        return None

    def _callee_by_name(self, func: ast.AST,
                        mod: str) -> Optional[FuncId]:
        """Module-level function a call target names, import-aware
        (``f()`` / ``alias.f()``); no receiver inference."""
        if isinstance(func, ast.Name):
            if (mod, "", func.id) in self.functions:
                return (mod, "", func.id)
            sym = self._imports_sym.get(mod, {}).get(func.id)
            if sym is not None and \
                    (sym[0], "", sym[1]) in self.functions:
                return (sym[0], "", sym[1])
            return None
        if isinstance(func, ast.Attribute) and \
                not isinstance(func.value, ast.Call):
            tmod = self._resolve_module(unparse(func.value), mod)
            if tmod is not None and \
                    (tmod, "", func.attr) in self.functions:
                return (tmod, "", func.attr)
        return None

    def _resolve_type_expr(self, expr: ast.AST,
                           mod: str) -> Optional[Tuple[str, str]]:
        """Resolve a type annotation / base-class / ctor expression to a
        project class key, or None."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                expr = ast.parse(expr.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(expr, ast.Subscript):  # Optional[X] / List[X]
            base = unparse(expr.value)
            if base.rsplit(".", 1)[-1] in ("Optional", "Annotated"):
                sl = expr.slice
                if isinstance(sl, ast.Tuple) and sl.elts:
                    sl = sl.elts[0]
                return self._resolve_type_expr(sl, mod)
            return None
        if isinstance(expr, ast.Name):
            name = expr.id
            if (mod, name) in self._classes:
                return (mod, name)
            sym = self._imports_sym.get(mod, {}).get(name)
            if sym is not None:
                smod, sname = sym
                if (smod, sname) in self._classes:
                    return (smod, sname)
                # from pkg import mod_as_symbol — not a class.
            return None
        if isinstance(expr, ast.Attribute):
            prefix = unparse(expr.value)
            tmod = self._resolve_module(prefix, mod)
            if tmod is not None and (tmod, expr.attr) in self._classes:
                return (tmod, expr.attr)
            return None
        return None

    def _resolve_module(self, dotted: str, mod: str) -> Optional[str]:
        """Resolve a dotted prefix (as written in source) to a project
        module name, through aliases and plain imports."""
        parts = dotted.split(".")
        head = parts[0]
        imods = self._imports_mod.get(mod, {})
        if head in imods:
            cand = ".".join([imods[head]] + parts[1:])
            if cand in self.modules:
                return cand
            return None
        sym = self._imports_sym.get(mod, {}).get(head)
        if sym is not None:
            cand = ".".join([f"{sym[0]}.{sym[1]}"] + parts[1:])
            if cand in self.modules:
                return cand
        if dotted in self._plain_imports.get(mod, ()) and \
                dotted in self.modules:
            return dotted
        # `import a.b.c` binds `a`; any prefix of the dotted path that
        # was plainly imported makes the whole path resolvable.
        for p in self._plain_imports.get(mod, ()):
            if dotted == p or dotted.startswith(p + ".") or \
                    p.startswith(dotted + "."):
                if dotted in self.modules:
                    return dotted
        return None

    def _mro(self, ckey: Tuple[str, str]) -> List[Tuple[str, str]]:
        out, stack, seen = [], [ckey], set()
        while stack:
            cur = stack.pop(0)
            if cur in seen or cur not in self._classes:
                continue
            seen.add(cur)
            out.append(cur)
            stack.extend(self._bases.get(cur, ()))
        return out

    def _lookup_method(self, ckey: Tuple[str, str],
                       name: str) -> Optional[FuncId]:
        for c in self._mro(ckey):
            fid = (c[0], c[1], name)
            if fid in self.functions:
                return fid
        return None

    def class_attr_types(self, ckey: Tuple[str, str],
                         attr: str) -> Set[Tuple[str, str]]:
        out: Set[Tuple[str, str]] = set()
        for c in self._mro(ckey):
            out |= self._attr_types.get(c, {}).get(attr, set())
        return out

    # --------------------------------------------------------- resolution

    def fid_of(self, src: Source, fn: ast.AST) -> Optional[FuncId]:
        return self._fid_of_node.get(id(fn))

    def _enclosing_ckey(self, src: Source,
                        node: ast.AST) -> Optional[Tuple[str, str]]:
        cls = src.enclosing_class(node)
        if cls is None:
            return None
        return (self.canonical(src.modname), cls.name)

    def _local_types(self, src: Source,
                     fn: ast.AST) -> Dict[str, Set[Tuple[str, str]]]:
        cached = self._local_types_cache.get(id(fn))
        if cached is not None:
            return cached
        mod = self.canonical(src.modname)
        out: Dict[str, Set[Tuple[str, str]]] = {}
        # Publish the (partial) map BEFORE inferring from call results:
        # typing ``fut = nm.request_nowait(...)`` resolves the inner
        # call, which may consult this same function's local types —
        # the early publish turns that recursion into a lookup of the
        # annotations gathered so far instead of an infinite loop.
        self._local_types_cache[id(fn)] = out
        args = fn.args
        for p in args.posonlyargs + args.args + args.kwonlyargs:
            if p.annotation is not None:
                t = self._resolve_type_expr(p.annotation, mod)
                if t is not None:
                    out.setdefault(p.arg, set()).add(t)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.AnnAssign) and \
                    isinstance(sub.target, ast.Name):
                t = self._resolve_type_expr(sub.annotation, mod)
                if t is not None:
                    out.setdefault(sub.target.id, set()).add(t)
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                continue
            tgt = sub.targets[0]
            if isinstance(tgt, ast.Name):
                names = [tgt.id]
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                # ``a, b = pair()``: union typing per name — method-name
                # dispatch prunes the over-approximation downstream.
                names = [e.id for e in tgt.elts
                         if isinstance(e, ast.Name)]
            else:
                continue
            if not names:
                continue
            vals = [sub.value.body, sub.value.orelse] \
                if isinstance(sub.value, ast.IfExp) else [sub.value]
            for val in vals:
                t = self._value_type(val, mod)
                types = {t} if t is not None else (
                    self.infer_expr_types(src, val, sub)
                    if isinstance(val, (ast.Call, ast.Attribute,
                                        ast.Subscript)) else set())
                for n in names:
                    if types:
                        out.setdefault(n, set()).update(types)
        return out

    def _module_var_types(self, mod: str) -> Dict[str, Set[Tuple[str, str]]]:
        """Types of module-level variables (``_global_worker:
        Optional[CoreWorker] = None`` / ``_cluster = _LocalCluster()``)
        — the fallback when a Name has no function-local type."""
        cached = self._module_var_cache.get(mod)
        if cached is not None:
            return cached
        out: Dict[str, Set[Tuple[str, str]]] = {}
        self._module_var_cache[mod] = out
        src = self.modules.get(mod)
        if src is None:
            return out
        for node in src.tree.body:
            if isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                for t in self._annotation_types(node.annotation, mod):
                    out.setdefault(node.target.id, set()).add(t)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                t = self._value_type(node.value, mod)
                if t is not None:
                    out.setdefault(node.targets[0].id, set()).add(t)
        return out

    def _call_return_types(self, src: Source, call: ast.Call,
                           ctx: ast.AST) -> Set[Tuple[str, str]]:
        """Project classes a call expression may evaluate to: ctor
        calls type as the class, annotated functions/methods as their
        return annotation (resolved in the CALLEE's module, so
        ``-> protocol.Conn`` and ``-> "_Future"`` both land)."""
        mod = self.canonical(src.modname)
        t = self._resolve_type_expr(call.func, mod)
        if t is not None:
            return {t}
        out: Set[Tuple[str, str]] = set()
        for fid, _off in self.resolve(src, call, ctx):
            info = self.functions.get(fid)
            if info is None:
                continue
            if fid[2] == "__init__" and fid[1]:
                out.add((fid[0], fid[1]))
                continue
            ret = getattr(info.node, "returns", None)
            if ret is not None:
                out |= self._annotation_types(
                    ret, self.canonical(info.src.modname))
        return out

    def _annotation_types(self, expr: ast.AST,
                          mod: str) -> Set[Tuple[str, str]]:
        """All project classes an annotation may denote — a
        ``Tuple[A, B, C]`` return unions its elements (method-name
        dispatch prunes the over-approximation at lookup time)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                expr = ast.parse(expr.value, mode="eval").body
            except SyntaxError:
                return set()
        if isinstance(expr, ast.Subscript) and \
                unparse(expr.value).rsplit(".", 1)[-1] in ("Tuple",
                                                           "tuple"):
            elts = expr.slice.elts if isinstance(expr.slice, ast.Tuple) \
                else [expr.slice]
            out: Set[Tuple[str, str]] = set()
            for e in elts:
                t = self._resolve_type_expr(e, mod)
                if t is not None:
                    out.add(t)
            return out
        t = self._resolve_type_expr(expr, mod)
        return {t} if t else set()

    def infer_expr_types(self, src: Source, expr: ast.AST,
                         ctx_node: ast.AST) -> Set[Tuple[str, str]]:
        """Candidate project classes for the value of ``expr`` at
        ``ctx_node`` (receiver-type inference). Empty set = unknown."""
        mod = self.canonical(src.modname)
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                ckey = self._enclosing_ckey(src, ctx_node)
                return {ckey} if ckey else set()
            fn = src.enclosing_function(ctx_node)
            if fn is not None:
                types = self._local_types(src, fn).get(expr.id)
                if types:
                    return set(types)
            return set(self._module_var_types(mod).get(expr.id, ()))
        if isinstance(expr, ast.Call):
            got = self._call_return_types(src, expr, ctx_node)
            if got:
                return got
            t = self._value_type(expr, mod)
            return {t} if t else set()
        if isinstance(expr, ast.Attribute):
            base_types = self.infer_expr_types(src, expr.value, ctx_node)
            out: Set[Tuple[str, str]] = set()
            for bt in base_types:
                out |= self.class_attr_types(bt, expr.attr)
            return out
        if isinstance(expr, ast.Subscript):
            # `self._m["shed"]` — element types of the container literal.
            return self.infer_expr_types(src, expr.value, ctx_node)
        return set()

    def resolve(self, src: Source, call: ast.Call,
                ctx: Optional[ast.AST] = None
                ) -> List[Tuple[FuncId, int]]:
        """Resolve a call to [(FuncId, arg_offset)] — arg_offset is the
        number of leading callee parameters not present in the call's
        argument list (1 for the implicit self of bound calls)."""
        ctx = ctx if ctx is not None else call
        mod = self.canonical(src.modname)
        out: List[Tuple[FuncId, int]] = []

        def add(fid: Optional[FuncId], offset: int) -> None:
            if fid is not None and fid in self.functions and \
                    (fid, offset) not in out:
                out.append((fid, offset))

        # ``super().__init__(...)`` / ``super().meth(...)``: dispatch to
        # the first base class up the MRO that defines the method.
        if isinstance(call.func, ast.Attribute) and \
                isinstance(call.func.value, ast.Call) and \
                isinstance(call.func.value.func, ast.Name) and \
                call.func.value.func.id == "super":
            ckey = self._enclosing_ckey(src, ctx)
            if ckey is not None:
                for c in self._mro(ckey)[1:]:
                    fid = (c[0], c[1], call.func.attr)
                    if fid in self.functions:
                        add(fid, 1)
                        break
            return out

        # Method on a call RESULT — ``w.nm_conn(addr).request(...)``,
        # ``metrics_tuple()[0].inc(...)``: type the receiver expression
        # (return annotations, tuple-element unions) and dispatch.
        if isinstance(call.func, ast.Attribute) and \
                any(isinstance(n, ast.Call)
                    for n in ast.walk(call.func.value)):
            for t in sorted(self.infer_expr_types(
                    src, call.func.value, ctx)):
                add(self._lookup_method(t, call.func.attr), 1)
            return out

        name = call_name(call)
        if "?" in name or "(" in name:
            return []
        parts = name.split(".")

        # self.meth() / self.attr.meth() / self.cb()
        if parts[0] == "self":
            ckey = self._enclosing_ckey(src, ctx)
            if ckey is None:
                return []
            if len(parts) == 2:
                m = self._lookup_method(ckey, parts[1])
                if m is not None:
                    add(m, 1)
                else:
                    for c in self._mro(ckey):
                        bm = self._attr_methods.get(c, {}).get(parts[1])
                        if bm is not None:
                            add(bm, 1)
                            break
            elif len(parts) == 3:
                for t in self.class_attr_types(ckey, parts[1]):
                    add(self._lookup_method(t, parts[2]), 1)
            return out

        # Local-variable / parameter receivers: obj.meth(), obj.attr.meth()
        # — falling back to module-level variable types (_global_worker).
        fn = src.enclosing_function(ctx)
        if len(parts) >= 2:
            types = self._local_types(src, fn).get(parts[0], set()) \
                if fn is not None else set()
            if not types:
                types = self._module_var_types(mod).get(parts[0], set())
            if types and len(parts) == 2:
                for t in types:
                    add(self._lookup_method(t, parts[1]), 1)
            elif types and len(parts) == 3:
                for t in types:
                    for t2 in self.class_attr_types(t, parts[1]):
                        add(self._lookup_method(t2, parts[2]), 1)
            if out:
                return out

        # Bare name: local function / class ctor / from-imported symbol.
        if len(parts) == 1:
            add((mod, "", parts[0]), 0)
            if (mod, parts[0]) in self._classes:
                add(self._lookup_method((mod, parts[0]), "__init__"), 1)
            sym = self._imports_sym.get(mod, {}).get(parts[0])
            if sym is not None:
                smod, sname = sym
                add((smod, "", sname), 0)
                if (smod, sname) in self._classes:
                    add(self._lookup_method((smod, sname), "__init__"), 1)
            return out

        # Dotted: module.func / module.Class() / module.Class.meth /
        # Class.meth (from-imported class).
        prefix = ".".join(parts[:-1])
        leaf = parts[-1]
        tmod = self._resolve_module(prefix, mod)
        if tmod is not None:
            add((tmod, "", leaf), 0)
            if (tmod, leaf) in self._classes:
                add(self._lookup_method((tmod, leaf), "__init__"), 1)
        if len(parts) >= 3:
            tmod2 = self._resolve_module(".".join(parts[:-2]), mod)
            if tmod2 is not None and (tmod2, parts[-2]) in self._classes:
                add(self._lookup_method((tmod2, parts[-2]), leaf), 0)
        if len(parts) == 2:
            # ClassName.meth(...) where ClassName is local/imported.
            t = self._resolve_type_expr(ast.Name(id=parts[0]), mod)
            if t is not None:
                add(self._lookup_method(t, leaf), 0)
        return out

    # ----------------------------------------------------- direct op scan

    def _under_await(self, src: Source, node: ast.AST,
                     stop: ast.AST) -> bool:
        for anc in src.ancestors(node):
            if anc is stop:
                return False
            if isinstance(anc, ast.Await):
                return True
        return False

    def _cv_idiom(self, src: Source, call: ast.Call, name: str,
                  fn: ast.AST) -> bool:
        """``cv.wait()`` under ``with cv:`` releases the lock — the
        Condition idiom, not a blocking op to propagate."""
        if name.rsplit(".", 1)[-1] not in ("wait", "wait_for"):
            return False
        recv = name.rpartition(".")[0]
        if not recv:
            return False
        for anc in src.ancestors(call):
            if anc is fn:
                break
            if isinstance(anc, ast.With):
                for item in anc.items:
                    if unparse(item.context_expr) == recv:
                        return True
        return False

    def _unbounded_direct(self, src: Source, call: ast.Call,
                          info: FuncInfo,
                          bounded: set) -> Optional[Item]:
        """Classify a call as an unbounded-wait item for the summary
        (possibly conditional on a caller-supplied bound)."""
        name = call_name(call)
        leaf = name.rsplit(".", 1)[-1]
        cands: List[ast.AST] = [kw.value for kw in call.keywords
                                if kw.arg in TIMEOUT_KWS]
        kind: Optional[str] = None
        if name in GET_NAMES:
            kind = name
            cands += call.args[1:2]
        elif leaf == "request" and "." in name:
            if isinstance(call.func, ast.Attribute):
                recv = call.func.value
                rleaf = recv.id if isinstance(recv, ast.Name) else (
                    recv.attr if isinstance(recv, ast.Attribute) else None)
                if rleaf in bounded:
                    return None
                # Cross-module: a receiver whose inferred type IS the
                # channel class gets the same default-bound exemption
                # (w.gcs.request in helpers outside worker.py).
                if any(cn == "_GcsChannel" for _m, cn in
                       self.infer_expr_types(src, recv, call)):
                    return None
            kind = name
            cands += call.args[2:3]
        elif leaf in ZERO_ARG_WAITERS and "." in name and \
                len(call.args) <= 1:
            head = name.rpartition(".")[0]
            if leaf == "join" and (head.endswith("path")
                                   or literal_receiver(call)):
                return None  # os.path.join / str.join, not thread.join
            kind = name
            cands += call.args[0:1]
        elif leaf == "wait_for" and "." in name:
            kind = name
            cands += call.args[1:2]
        elif leaf == "get" and "." in name and not call.args and \
                any(h in name.lower() for h in QUEUE_HINTS):
            if has_kw(call, "block"):
                return None
            kind = name
        elif leaf == "_coord_call":
            kind = name
            cands += [kw.value for kw in call.keywords
                      if kw.arg == "deadline"]
            cands += call.args[1:2]
        if kind is None:
            return None
        if not cands:
            return ("unbounded", kind)
        for c in cands:
            if isinstance(c, ast.Constant) and c.value is None:
                return ("unbounded", kind)
            if isinstance(c, ast.Name) and c.id in info.params + info.kwonly:
                d = info.defaults.get(c.id)
                if d is None and c.id in info.defaults:
                    continue
                if d is None or (isinstance(d, ast.Constant) and
                                 d.value is None):
                    return ("unbounded?", kind, c.id)
        return None  # a concrete bound was passed

    def _build_edges_and_direct(self) -> None:
        self._edges = {}
        self._sum = {}
        bounded_cache: Dict[str, set] = {}
        for fid, info in self.functions.items():
            src, fn = info.src, info.node
            items: Set[Item] = set()
            edges: List[Edge] = []
            bounded = bounded_cache.get(src.rel)
            if bounded is None:
                bounded = bounded_cache[src.rel] = bounded_channels(src)
            for call in walk_calls(fn):
                if src.enclosing_function(call) is not fn:
                    continue
                awaited = self._under_await(src, call, fn)
                if not awaited:
                    name = call_name(call)
                    b = blocking_name(call)
                    if b is not None and not self._cv_idiom(src, call,
                                                            name, fn):
                        it: Item = ("block", b)
                        items.add(it)
                        self._wit.setdefault(
                            (fid, it),
                            ("direct", src.rel, call.lineno, call))
                    u = self._unbounded_direct(src, call, info, bounded)
                    if u is not None:
                        items.add(u)
                        self._wit.setdefault(
                            (fid, u),
                            ("direct", src.rel, call.lineno, call))
                for callee, offset in self.resolve(src, call):
                    edges.append(Edge(fid, callee, call, call.lineno,
                                      awaited, offset, src))
            for node in ast.walk(fn):
                if isinstance(node, ast.With) and \
                        src.enclosing_function(node) is fn:
                    for item in node.items:
                        lid = self.project.resolve_lock(
                            src, item.context_expr, node)
                        if lid is not None:
                            it = ("lock", lid)
                            items.add(it)
                            self._wit.setdefault(
                                (fid, it),
                                ("direct", src.rel, node.lineno, node))
            self._sum[fid] = items
            self._edges[fid] = edges

    def _under_await_direct(self, src: Source, call: ast.Call) -> bool:
        """Is the call the (possibly indirect) operand of an await?"""
        return isinstance(src.parent(call), ast.Await) or \
            self._under_await(src, call, src.enclosing_function(call)
                              or src.tree)

    # --------------------------------------------------------- fixed point

    def _propagates(self, caller: FuncInfo, edge: Edge,
                    callee: FuncInfo) -> bool:
        if callee.is_async:
            return caller.is_async and edge.awaited
        return True

    def _lift(self, item: Item, edge: Edge,
              caller: FuncInfo, callee: FuncInfo) -> Optional[Item]:
        if item[0] != "unbounded?":
            return item
        _, kind, pname = item
        call = edge.call
        val: Optional[ast.AST] = None
        supplied = False
        if pname in callee.params:
            pos = callee.params.index(pname) - edge.offset
            if 0 <= pos < len(call.args):
                val, supplied = call.args[pos], True
        if not supplied:
            for kw in call.keywords:
                if kw.arg == pname:
                    val, supplied = kw.value, True
                    break
        if not supplied:
            if any(kw.arg is None for kw in call.keywords) or \
                    any(isinstance(a, ast.Starred) for a in call.args):
                return None  # **kwargs / *args: can't tell, assume bounded
            d = callee.defaults.get(pname)
            if d is None and pname not in callee.defaults:
                return None  # required param not passed: not a real call
            if isinstance(d, ast.Constant) and d.value is None:
                return ("unbounded", kind)
            return None
        if isinstance(val, ast.Constant) and val.value is None:
            return ("unbounded", kind)
        if isinstance(val, ast.Name) and \
                val.id in caller.params + caller.kwonly:
            cd = caller.defaults.get(val.id)
            if val.id not in caller.defaults or \
                    (isinstance(cd, ast.Constant) and cd.value is None):
                return ("unbounded?", kind, val.id)
        return None  # caller passed a concrete bound

    def summaries(self) -> Dict[FuncId, Set[Item]]:
        if self._sum is None or self._edges is None:
            self._build_edges_and_direct()
        elif getattr(self, "_fixed", False):
            return self._sum
        rounds = 0
        max_rounds = self.depth if self.depth is not None else 80
        changed = True
        while changed and rounds < max_rounds:
            changed = False
            rounds += 1
            for caller_fid, edges in self._edges.items():
                caller = self.functions[caller_fid]
                s = self._sum[caller_fid]
                for e in edges:
                    callee = self.functions.get(e.callee)
                    if callee is None:
                        continue
                    if not self._propagates(caller, e, callee):
                        continue
                    for item in list(self._sum[e.callee]):
                        lifted = self._lift(item, e, caller, callee)
                        if lifted is None or lifted in s:
                            continue
                        s.add(lifted)
                        self._wit[(caller_fid, lifted)] = (
                            "via", e.src.rel, e.line, e.callee, item,
                            e.call)
                        changed = True
        self._fixed = True
        return self._sum

    def summary(self, fid: FuncId) -> Set[Item]:
        return self.summaries().get(fid, set())

    # ------------------------------------------------------------ witnesses

    def chain(self, fid: FuncId, item: Item) -> List[str]:
        """Human-readable witness path for ``item`` in ``fid``'s summary:
        one call hop per line, the concrete op last."""
        out: List[str] = []
        seen: Set[Tuple[FuncId, Item]] = set()
        cur_fid, cur_item = fid, item
        while (cur_fid, cur_item) not in seen:
            seen.add((cur_fid, cur_item))
            w = self._wit.get((cur_fid, cur_item))
            if w is None:
                break
            if w[0] == "direct":
                out.append(f"{w[1]}:{w[2]}: {self.describe(cur_item)}")
                break
            out.append(f"{w[1]}:{w[2]}: {fid_str(cur_fid)} -> "
                       f"{fid_str(w[3])}")
            cur_fid, cur_item = w[3], w[4]
        return out

    def origin(self, fid: FuncId,
               item: Item) -> Optional[Tuple[str, int, ast.AST]]:
        """(rel, line, node) of the terminal direct op of a witness."""
        seen: Set[Tuple[FuncId, Item]] = set()
        cur_fid, cur_item = fid, item
        while (cur_fid, cur_item) not in seen:
            seen.add((cur_fid, cur_item))
            w = self._wit.get((cur_fid, cur_item))
            if w is None:
                return None
            if w[0] == "direct":
                return (w[1], w[2], w[3])
            cur_fid, cur_item = w[3], w[4]
        return None

    def chain_fids(self, fid: FuncId, item: Item) -> List[FuncId]:
        out: List[FuncId] = [fid]
        seen: Set[Tuple[FuncId, Item]] = set()
        cur_fid, cur_item = fid, item
        while (cur_fid, cur_item) not in seen:
            seen.add((cur_fid, cur_item))
            w = self._wit.get((cur_fid, cur_item))
            if w is None or w[0] == "direct":
                break
            out.append(w[3])
            cur_fid, cur_item = w[3], w[4]
        return out

    @staticmethod
    def describe(item: Item) -> str:
        if item[0] == "block":
            return f"blocking {item[1]}(...)"
        if item[0] == "unbounded":
            return f"{item[1]}(...) with no timeout"
        if item[0] == "unbounded?":
            return f"{item[1]}(...) unbounded unless {item[2]} is passed"
        if item[0] == "lock":
            return f"acquires {item[1]}"
        return str(item)

    # ------------------------------------------- with-site blocking lookup

    def blocking_in_with(self, src: Source, with_node: ast.With,
                         lock_texts: Set[str]) -> List[tuple]:
        """Blocking reachable from inside a ``with`` body while the lock
        is held: [(call, ("direct", name))] or
        [(call, ("via", callee_fid, item))]. Skips nested defs, the
        with-items themselves, awaited calls, and the Condition idiom."""
        fn = src.enclosing_function(with_node)
        out: List[tuple] = []
        item_exprs = [i.context_expr for i in with_node.items]
        for call in walk_calls(with_node):
            if src.enclosing_function(call) is not fn:
                continue
            if any(call is e or any(call is sub for sub in ast.walk(e))
                   for e in item_exprs):
                continue
            if fn is not None and self._under_await(src, call, fn):
                continue
            name = call_name(call)
            recv = name.rpartition(".")[0]
            if name.rsplit(".", 1)[-1] in ("wait", "wait_for") and \
                    recv in lock_texts:
                continue
            b = blocking_name(call)
            if b is not None:
                out.append((call, ("direct", b)))
                continue
            for callee, _offset in self.resolve(src, call):
                cinfo = self.functions.get(callee)
                if cinfo is not None and cinfo.is_async:
                    continue  # calling a coroutine fn only builds the coro
                blocks = sorted(it for it in self.summary(callee)
                                if it[0] == "block")
                if blocks:
                    out.append((call, ("via", callee, blocks[0])))
                    break
        return out

    # ------------------------------------------------------- lock graph

    def _resolve_lock_multi(self, src: Source, expr: ast.AST,
                            ctx: ast.AST) -> List[str]:
        """Lock ids a with-item may acquire. Beyond single-site
        resolution: ``with lock:`` where ``lock`` is a for-loop target
        iterating a tuple/list LITERAL resolves to every lock the
        literal's elements mention (the GCS shard-probe idiom — one
        loop timing each shard lock in turn)."""
        lid = self.project.resolve_lock(src, expr, ctx)
        if lid is not None and ":" not in lid:
            return [lid]   # registered site: exact
        if not isinstance(expr, ast.Name):
            return [lid] if lid is not None else []
        fn = src.enclosing_function(ctx)
        out: List[str] = []
        for node in ast.walk(fn if fn is not None else src.tree):
            if not isinstance(node, ast.For) or \
                    src.enclosing_function(node) is not fn:
                continue
            tgt = node.target
            tgts = [tgt] if isinstance(tgt, ast.Name) else (
                list(tgt.elts) if isinstance(tgt, (ast.Tuple, ast.List))
                else [])
            if not any(isinstance(t, ast.Name) and t.id == expr.id
                       for t in tgts):
                continue
            if not isinstance(node.iter, (ast.Tuple, ast.List)):
                continue
            for elt in node.iter.elts:
                for subx in ast.walk(elt):
                    if isinstance(subx, (ast.Attribute, ast.Name)):
                        got = self.project.resolve_lock(src, subx, ctx)
                        if got is not None and ":" not in got and \
                                got not in out:
                            out.append(got)
        return out if out else ([lid] if lid is not None else [])

    def _build_lock_graph(self) -> None:
        """Project-wide static lock-order graph.

        Edges come from three shapes:
        - a ``with`` nested syntactically inside another ``with``,
        - a call under a ``with`` whose callee transitively acquires,
        - a manual ``L.acquire()`` region (to the matching ``.release()``
          or function end) containing acquisitions — these exist (the
          protocol writer's trylock) and the runtime witness sees their
          edges, so the static graph must too.
        """
        self.summaries()
        edges: Dict[Tuple[str, str], tuple] = {}
        self._self_nests = []
        nest_seen: Set[Tuple[str, str, int]] = set()

        def add(outer: str, inner: str, src: Source, line: int, how: str,
                node: ast.AST, chain: Sequence[str]) -> None:
            if outer == inner:
                if (outer, src.rel, line) not in nest_seen:
                    nest_seen.add((outer, src.rel, line))
                    self._self_nests.append(
                        (outer, src, node, line, how, tuple(chain)))
                return
            edges.setdefault((outer, inner),
                             (src.rel, line, how, tuple(chain)))

        # fn-id -> [(with_node, [lock ids], {id(descendant)})], for
        # held-set queries: which lock classes are statically held at a
        # given node (EVERY enclosing with in the function, not just the
        # one being processed). A transitive acquisition of an
        # already-held reentrant lock is a benign re-acquire — the
        # runtime witness skips same-class edges for exactly this
        # reason, and the static graph must agree or reconciliation
        # would demand edges lockdep refuses to record.
        fn_withs: Dict[int, list] = {}

        def withs_of(src: Source, fn) -> list:
            got = fn_withs.get(id(fn))
            if got is None:
                got = []
                for w in ast.walk(fn if fn is not None else src.tree):
                    if isinstance(w, ast.With) and \
                            src.enclosing_function(w) is fn:
                        lids = [l for i in w.items
                                for l in self._resolve_lock_multi(
                                    src, i.context_expr, w)]
                        if lids:
                            got.append(
                                (w, lids, {id(d) for d in ast.walk(w)}))
                fn_withs[id(fn)] = got
            return got

        def held_at(src: Source, fn, sub: ast.AST) -> Set[str]:
            held: Set[str] = set()
            for w, lids, ids in withs_of(src, fn):
                if w is not sub and id(sub) in ids:
                    held.update(lids)
            return held

        for src in self.project.sources:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.With):
                    continue
                outer_locks = []
                for item in node.items:
                    for lid in self._resolve_lock_multi(
                            src, item.context_expr, node):
                        outer_locks.append(lid)
                if not outer_locks:
                    continue
                fn = src.enclosing_function(node)
                item_exprs = [i.context_expr for i in node.items]
                for sub in ast.walk(node):
                    if sub is node:
                        continue
                    if isinstance(sub, ast.With) and \
                            src.enclosing_function(sub) is fn:
                        for item in sub.items:
                            for lid in self._resolve_lock_multi(
                                    src, item.context_expr, sub):
                                # The witness of a syntactic nesting is
                                # the inner acquisition itself.
                                wit = (f"{src.rel}:{sub.lineno}: "
                                       f"acquires {lid}",)
                                if lid in held_at(src, fn, sub):
                                    if not self.project. \
                                            lock_is_reentrant(lid):
                                        add(lid, lid, src, sub.lineno,
                                            "nested with", sub, wit)
                                    continue  # reentrant re-acquire
                                for outer in outer_locks:
                                    add(outer, lid, src, sub.lineno,
                                        "nested with", sub, wit)
                    elif isinstance(sub, ast.Call) and \
                            src.enclosing_function(sub) is fn:
                        if any(sub is e or
                               any(sub is s2 for s2 in ast.walk(e))
                               for e in item_exprs):
                            continue
                        if fn is not None and \
                                self._under_await(src, sub, fn):
                            continue
                        for callee, _off in self.resolve(src, sub):
                            cinfo = self.functions.get(callee)
                            if cinfo is not None and cinfo.is_async and \
                                    not self._under_await_direct(src, sub):
                                continue
                            for it in sorted(self.summary(callee)):
                                if it[0] != "lock":
                                    continue
                                ch = [f"{src.rel}:{sub.lineno}: call "
                                      f"{fid_str(callee)}"] + \
                                    self.chain(callee, it)
                                if it[1] in held_at(src, fn, sub):
                                    if not self.project. \
                                            lock_is_reentrant(it[1]):
                                        add(it[1], it[1], src,
                                            sub.lineno,
                                            f"via {fid_str(callee)}",
                                            sub, ch)
                                    continue
                                for outer in outer_locks:
                                    add(outer, it[1], src, sub.lineno,
                                        f"via {fid_str(callee)}", sub, ch)
            # Manual acquire()/release() regions.
            self._manual_regions(src, add)
        self._lock_graph = edges

    def _manual_regions(self, src: Source, add) -> None:
        for fid, info in self.functions.items():
            if info.src is not src:
                continue
            fn = info.node
            acquires = []
            releases: Dict[str, List[int]] = {}
            for call in walk_calls(fn):
                if src.enclosing_function(call) is not fn:
                    continue
                name = call_name(call)
                recv, _, leaf = name.rpartition(".")
                if leaf == "acquire" and recv and \
                        isinstance(call.func, ast.Attribute):
                    lid = self.project.resolve_lock(
                        src, call.func.value, call)
                    if lid is not None:
                        acquires.append((lid, recv, call))
                elif leaf == "release" and recv:
                    releases.setdefault(recv, []).append(call.lineno)
            if not acquires:
                continue
            fn_end = getattr(fn, "end_lineno", None) or 10 ** 9
            for lid, recv, acall in acquires:
                rel_lines = [ln for ln in releases.get(recv, ())
                             if ln >= acall.lineno]
                end = min(rel_lines) if rel_lines else fn_end
                for node in ast.walk(fn):
                    if isinstance(node, ast.With) and \
                            src.enclosing_function(node) is fn and \
                            acall.lineno < node.lineno <= end:
                        for item in node.items:
                            ilid = self.project.resolve_lock(
                                src, item.context_expr, node)
                            if ilid is not None:
                                add(lid, ilid, src, node.lineno,
                                    f"with after {recv}.acquire()", node,
                                    ())
                    elif isinstance(node, ast.Call) and \
                            src.enclosing_function(node) is fn and \
                            acall.lineno < node.lineno <= end:
                        for callee, _off in self.resolve(src, node):
                            for it in sorted(self.summary(callee)):
                                if it[0] != "lock":
                                    continue
                                ch = [f"{src.rel}:{node.lineno}: call "
                                      f"{fid_str(callee)}"] + \
                                    self.chain(callee, it)
                                add(lid, it[1], src, node.lineno,
                                    f"via {fid_str(callee)} after "
                                    f"{recv}.acquire()", node, ch)

    def lock_graph(self) -> Dict[Tuple[str, str], tuple]:
        """(outer, inner) -> (rel, line, how, chain)."""
        if self._lock_graph is None:
            self._build_lock_graph()
        return self._lock_graph

    def self_nests(self) -> List[tuple]:
        """[(lock_id, src, node, line, how, chain)] — re-acquisitions of
        a held lock (direct or transitive)."""
        if self._self_nests is None:
            self._build_lock_graph()
        return self._self_nests

    def hot_locks(self) -> Dict[str, tuple]:
        """Locks held across a (transitively reachable) blocking op at
        some with-site, project-wide: lock_id -> (rel, line, desc)."""
        if self._hot_locks is None:
            hot: Dict[str, tuple] = {}
            for src in self.project.sources:
                for node in ast.walk(src.tree):
                    if not isinstance(node, ast.With):
                        continue
                    lids, texts = [], set()
                    for item in node.items:
                        lid = self.project.resolve_lock(
                            src, item.context_expr, node)
                        if lid is not None:
                            lids.append(lid)
                            texts.add(unparse(item.context_expr))
                    if not lids:
                        continue
                    found = self.blocking_in_with(src, node, texts)
                    if not found:
                        continue
                    call, how = found[0]
                    desc = how[1] if how[0] == "direct" else \
                        self.describe(how[2])
                    for lid in lids:
                        hot.setdefault(lid, (src.rel, call.lineno, desc))
            self._hot_locks = hot
        return self._hot_locks


# --------------------------------------------------------------- exports

def emit_lock_graph(project: Project) -> dict:
    """JSON-able static lock-order graph for static<->runtime
    reconciliation (``--emit-lock-graph``). Lock sites use the same
    ``path:line`` creation-site keys as lockdep's runtime classes."""
    cg = project.callgraph()
    reg = project.lock_registry()
    locks = {lid: {"site": f"{info['source']}:{info['line']}",
                   "reentrant": bool(info["reentrant"])}
             for lid, info in sorted(reg.items())}
    edges = []
    for (outer, inner), (rel, line, how, chain) in \
            sorted(cg.lock_graph().items()):
        edges.append({"outer": outer, "inner": inner,
                      "at": f"{rel}:{line}", "how": how,
                      "chain": list(chain)})
    return {"version": 1, "locks": locks, "edges": edges}
