"""unbounded-wait: blocking waits without a timeout/deadline in
control-plane paths — direct, or reached transitively through helpers
outside the control plane via the whole-program call graph."""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ray_tpu_torch._private.lint.callgraph import GET_NAMES, fid_str
from ray_tpu_torch._private.lint.core import (
    CONTROL_PLANE,
    Project,
    Violation,
    call_name,
    has_kw,
    unparse,
)

RULE = "unbounded-wait"

EXPLAIN = """\
unbounded-wait — a blocking wait with no timeout/deadline in a daemon,
supervisor, or collective code path.

Why it matters here: a control-plane thread parked forever on a peer
that died (or wedged) is how one rank's failure becomes a whole-gang
hang. The canonical instance: a deferred worker-lease
reply the caller awaited with no bound — a worker that hung during
startup wedged that scheduling shape's entire pipeline until a human
intervened. Gang collectives are even less forgiving: every member must
reach the op, so one unbounded wait holds GPUs idle cluster-wide
(gang frameworks live or die on control-plane discipline).

What it flags (control-plane files only):
- ``ray.get(ref)`` / ``.request(...)`` RPCs without a ``timeout=``; the
  runtime seam's ``get`` (``self._rt.get``, ``rt.get``, ``runtime.get``,
  ``self._runtime.get``: the gang and serving paths take their runtime
  as an argument) counts as ``ray.get``
- ``.result()`` / ``.wait()`` / ``.join()`` with no timeout argument
- ``.wait_for(pred)`` without ``timeout=``
- ``.get()`` on queue-like receivers with no bound
- ``_coord_call(...)`` without its ``deadline`` argument
- socket ``.recv``/``.recv_into``/``.accept`` in functions that never
  call ``.settimeout``

Transitive findings: a control-plane call into a helper OUTSIDE the
control plane whose body (or further callees) parks with no bound is
flagged at the control-plane call site, with the witness chain attached.
Bounds propagate through the chain — a helper whose wait is bounded only
by its own ``timeout=None`` parameter is unbounded exactly at the call
sites that don't supply one.

What it deliberately does NOT flag: waits that pass any timeout (even a
variable — bounding is the caller's contract), dict ``.get(key)`` (has
a positional key argument), and ``.request`` on a receiver the file
binds to ``_GcsChannel`` — that channel applies the
``gcs_rpc_timeout_s`` bound by default (opting out requires the
explicit ``UNBOUNDED`` sentinel, which is a visible decision at the
call site). Raw ``protocol.Conn.request`` stays flagged. Chains that
pass through another control-plane function are skipped (the finding —
or its reasoned suppression — lives at the deeper site), as are chains
whose terminal op carries this rule's suppression.

Fix: thread a deadline through (config knobs exist for the collective
paths: RAY_TPU_TORCH_COLLECTIVE_OP_TIMEOUT_S etc.). A dedicated daemon thread
whose ONLY job is the blocking loop (e.g. a socket reader whose exit is
the conn close) is the legitimate exception — suppress it with
``# raylint: disable=unbounded-wait`` and say why in the comment.
"""

# Zero-arg forms of these attribute calls wait forever by default.
_ZERO_ARG_WAITERS = {"wait", "result", "join"}
_QUEUE_HINTS = ("queue", "inbox", "mailbox")
_SOCKET_WAITERS = {"recv", "recv_into", "accept"}
_TIMEOUT_KWS = ("timeout", "timeout_s", "timeout_ms", "deadline",
                "timeout_seconds")


def _leaf(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _bounded_channels(src) -> set:
    """Names (leaf identifiers) bound to a _GcsChannel in this file —
    one-file dataflow: seed on ``X = _GcsChannel(...)``, then propagate
    through plain aliasing assignments to a fixpoint (covers
    ``self._gcs = gcs`` in helper classes constructed with the
    channel)."""
    assigns = [n for n in ast.walk(src.tree) if isinstance(n, ast.Assign)]
    names: set = set()
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


def _fn_calls_settimeout(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call) and \
                call_name(sub).endswith(".settimeout"):
            return True
    return False


def _transitive(project: Project, src, node: ast.Call,
                seen: Set[tuple]) -> List[Violation]:
    """Flag a control-plane call whose NON-control-plane callee
    transitively parks with no bound."""
    cg = project.callgraph()
    out: List[Violation] = []
    if cg._under_await_direct(src, node):
        return out  # awaited: the loop's business (see async-blocking)
    for callee, offset in cg.resolve(src, node):
        info = cg.functions.get(callee)
        if info is None or info.src.rel in CONTROL_PLANE:
            continue  # flagged (or reasoned about) at the deeper site
        if info.is_async:
            continue
        for item in sorted(cg.summary(callee)):
            # Witness entries live under the item as stored in the
            # callee's summary; lift conditional bounds for the verdict
            # but keep the original key for witness lookups.
            wit_item = item
            if item[0] == "unbounded?":
                item = cg._lift(item, _CallEdge(node, offset),
                                _NO_PARAMS, info)
                if item is None or item[0] != "unbounded":
                    continue
            elif item[0] != "unbounded":
                continue
            if any(cg.functions[f].src.rel in CONTROL_PLANE
                   for f in cg.chain_fids(callee, wit_item)
                   if f in cg.functions):
                continue  # the chain re-enters the control plane
            origin = cg.origin(callee, wit_item)
            if origin is None:
                continue
            orel, _oline, onode = origin
            key = (src.rel, node.lineno, item[1], orel)
            if key in seen:
                continue
            seen.add(key)
            osrc = project.by_rel.get(orel)
            if osrc is not None and osrc.is_node_suppressed(RULE, onode):
                continue
            if src.is_node_suppressed(RULE, node):
                continue
            chain = ([f"{src.rel}:{node.lineno}: calls "
                      f"{fid_str(callee)}"] + cg.chain(callee, wit_item))
            out.append(src.violation(
                RULE, node,
                f"call into {fid_str(callee)}() parks with no bound: "
                f"{item[1]}(...) at {chain[-1].rsplit(': ', 1)[0]}",
                chain=chain))
    return out


class _CallEdge:
    """Just enough of callgraph.Edge for _lift at a checker call site."""

    def __init__(self, call: ast.Call, offset: int):
        self.call = call
        self.offset = offset


class _NoParams:
    params: list = []
    kwonly: list = []
    defaults: dict = {}


_NO_PARAMS = _NoParams()


def check_project(project: Project) -> List[Violation]:
    out: List[Violation] = []
    seen_transitive: Set[tuple] = set()
    for src in project.control_plane():
        bounded = _bounded_channels(src)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "request" and isinstance(node.func, ast.Attribute) \
                    and _leaf(node.func.value) in bounded:
                continue  # _GcsChannel: bounded by default (see EXPLAIN)
            msg = None
            if name in GET_NAMES and \
                    not has_kw(node, *_TIMEOUT_KWS) and len(node.args) < 2:
                msg = f"{name}() without a timeout blocks forever if the " \
                      f"producer died"
            elif leaf == "request" and "." in name and \
                    not has_kw(node, *_TIMEOUT_KWS) and len(node.args) < 3:
                msg = f"RPC {name}(...) without timeout= waits forever " \
                      f"on a wedged peer"
            elif leaf in _ZERO_ARG_WAITERS and "." in name and \
                    not node.args and not has_kw(node, *_TIMEOUT_KWS):
                msg = f"{name}() with no timeout parks this thread " \
                      f"until the peer cooperates"
            elif leaf == "wait_for" and "." in name and \
                    not has_kw(node, *_TIMEOUT_KWS) and len(node.args) < 2:
                msg = f"{name}(pred) without timeout= can wait forever " \
                      f"for a notify that never comes"
            elif leaf == "get" and "." in name and not node.args and \
                    not has_kw(node, *_TIMEOUT_KWS, "block") and \
                    any(h in name.lower() for h in _QUEUE_HINTS):
                msg = f"queue {name}() without a timeout"
            elif leaf == "_coord_call" and \
                    not has_kw(node, "deadline") and len(node.args) < 2:
                msg = "_coord_call without a deadline: a poisoned " \
                      "coordinator would hold this collective forever"
            elif leaf in _SOCKET_WAITERS and "." in name:
                fn = src.enclosing_function(node)
                if fn is not None and not _fn_calls_settimeout(fn):
                    msg = f"socket {name}() in a function that never " \
                          f"sets a socket timeout"
            if msg is None:
                # Not a direct wait — but the callee may park, cross-
                # module, with no bound. Awaited calls are the loop's
                # business (async-blocking covers those paths).
                out.extend(_transitive(project, src, node,
                                       seen_transitive))
                continue
            if src.is_node_suppressed(RULE, node):
                continue
            out.append(src.violation(RULE, node, msg))
    return out
