"""hold-release: resource holds (ledger subtracts, GPU acquisitions,
store pins) without a release on raise edges."""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from ray_tpu_torch._private.lint.core import (
    Project,
    Source,
    Violation,
    call_name,
    unparse,
    walk_calls,
)

RULE = "hold-release"

EXPLAIN = """\
hold-release — a resource hold acquired without a matching release on
every raise edge that can follow it.

The repo's three hold kinds, each with a history:
- local-ledger holds (``_local_avail.subtract/.acquire``): an early
  finding was exactly this — ``_spawn_worker`` raising after the
  mirror-subtract leaked the hold, and every failed spawn permanently
  shrank the node's schedulable capacity. The hand-retrofitted fix is
  the ``attached[]``-guard: release in an ``except BaseException`` until
  the hold is bound to a WorkerHandle whose death path owns it.
- GPU holds (``_acquire_gpus``): a leaked GPU never returns to
  ``_free_gpus`` — the node reports GPU capacity it can never grant,
  and gang placement starves.
- store pins (``store.get_buffer``): a pin leak makes the arena slot
  unreclaimable; under eviction pressure the store fills with zombie
  pins and every create starts failing.

What it flags: an acquire followed (in the same function) by an explicit
``raise`` or a spawn/RPC call that can raise, where no enclosing ``try``
releases the hold in a handler or ``finally``, and no release is
lexically interposed.

What it deliberately does NOT flag: custody transfer — a hold recorded
into a ``*_held*`` registry adjacent to the acquire (the task/actor
bookkeeping maps) has an owner whose completion/death path releases it;
that is the repo's sanctioned pattern.

Fix: wrap the risky tail in ``try/except BaseException`` that releases
(the attached[]-guard if custody may transfer mid-flight), or release in
``finally``. If custody genuinely transfers through a channel this
checker cannot see, suppress with a comment naming the release path.
"""

_RISKY_CALL = re.compile(
    r"(_spawn_worker|Popen|\brequest\b|_checkout_worker|"
    r"_materialize_runtime_env|put_serialized|\bcreate\b)")

_KINDS = [
    {
        "name": "local-ledger hold",
        "acquire": re.compile(r"_local_avail\.(subtract|acquire)$"),
        "release": re.compile(r"_local_avail\.release"),
        "custody": re.compile(r"_held"),
    },
    {
        "name": "GPU hold",
        "acquire": re.compile(r"(^|\.)_acquire_gpus$"),
        "release": re.compile(r"_free_gpus\.(add|update)"
                              r"|_release_gpus"),
        "custody": None,
    },
    {
        "name": "store pin",
        "acquire": re.compile(r"\.get_buffer$"),
        "release": re.compile(r"\.release\b"),
        "custody": None,
    },
]


def _release_in(kind, nodes) -> bool:
    for n in nodes:
        for call in walk_calls(n):
            if kind["release"].search(call_name(call)):
                return True
            # ``for c in gpus: self._free_gpus.add(c)`` etc. are
            # calls too, caught above; assignments that null the hold
            # hand it elsewhere — treat ``x, y = y, None`` swaps as
            # release-ish only via explicit release calls (strict).
    return False


def _protected(src: Source, node: ast.AST, fn: ast.AST, kind) -> bool:
    """Some Try between ``node`` and the function boundary releases this
    kind in a handler or finally."""
    for anc in src.ancestors(node):
        if anc is fn:
            break
        if isinstance(anc, ast.Try):
            if _release_in(kind, anc.handlers) or \
                    _release_in(kind, anc.finalbody):
                return True
    return False


def _has_custody(kind, stmt: ast.stmt) -> bool:
    """An assignment into a *_held* registry in the same statement block
    as the acquire (the bookkeeping map whose owner releases later)."""
    if kind["custody"] is None:
        return False
    parent_body = getattr(stmt, "_raylint_parent", None)
    scan = []
    if parent_body is not None:
        for fieldname in ("body", "orelse", "finalbody"):
            scan.extend(getattr(parent_body, fieldname, []) or [])
    for sib in scan:
        for sub in ast.walk(sib):
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                tgt_list = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for tgt in tgt_list:
                    if kind["custody"].search(unparse(tgt)):
                        return True
    return False


def check_project(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.control_plane():
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            acquires: List[Tuple[ast.Call, dict]] = []
            for call in walk_calls(fn):
                if src.enclosing_function(call) is not fn:
                    continue
                cname = call_name(call)
                for kind in _KINDS:
                    if kind["acquire"].search(cname):
                        acquires.append((call, kind))
            if not acquires:
                continue
            raises = [n for n in ast.walk(fn) if isinstance(n, ast.Raise)
                      and src.enclosing_function(n) is fn]
            risky = [c for c in walk_calls(fn)
                     if src.enclosing_function(c) is fn
                     and _RISKY_CALL.search(call_name(c))]
            for acq, kind in acquires:
                stmt = acq
                for anc in src.ancestors(acq):
                    if isinstance(anc, ast.stmt):
                        stmt = anc
                        break
                if _has_custody(kind, stmt):
                    continue
                kind_releases = [c.lineno for c in walk_calls(fn)
                                 if kind["release"].search(call_name(c))]
                hazards = []
                for r in raises + risky:
                    if r.lineno <= acq.lineno or r is acq:
                        continue
                    # A release lexically between acquire and hazard
                    # (the early-release pattern) clears it.
                    if any(acq.lineno < ln <= r.lineno
                           for ln in kind_releases):
                        continue
                    if _protected(src, r, fn, kind):
                        continue
                    hazards.append(r)
                if not hazards:
                    continue
                hz = hazards[0]
                what = "raise" if isinstance(hz, ast.Raise) else \
                    f"call to {call_name(hz)}"
                if src.is_node_suppressed(RULE, acq, stmt, hz):
                    continue
                out.append(src.violation(
                    RULE, acq,
                    f"{kind['name']} acquired here but a {what} at line "
                    f"{hz.lineno} can exit without releasing it (no "
                    f"try/finally or except-release covers that edge)"))
    return out
