"""exception-swallow: broad except blocks in gang/collective/supervisor
paths that can eat gang-death errors silently."""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch._private.lint.core import Project, Violation, call_name

RULE = "exception-swallow"

EXPLAIN = """\
exception-swallow — an ``except Exception`` (or bare ``except``) in a
gang / collective / supervisor path whose body neither re-raises, nor
logs, nor propagates the caught error by hand.

Why scoped to gang paths: ``GangMemberDiedError`` and ``RayActorError``
are load-bearing control flow there. The poison protocol only works
because a pending collective RAISES when the coordinator is poisoned —
a broad handler that swallows it turns "bounded detection within ~2x
heartbeat" back into "wait out the full 300 s op deadline" (or forever),
which is precisely the wedge gang fault tolerance exists to prevent.
Elsewhere in the tree, ``except Exception: pass`` on a best-effort
notify is routine shutdown hygiene and is not flagged.

What counts as handling: any ``raise`` in the body (including
``isinstance``-gated re-raise of gang errors), any logging call
(``logger.*`` / ``.exception`` / ``warnings.warn``), or any use of the
bound exception name (storing it, passing it to a callback — the error
is being propagated by hand).

Fix: catch the narrow exceptions you mean, re-raise gang errors
(``except GangMemberDiedError: raise``) before the broad handler, or at
minimum log with the exception attached. If the swallow is genuinely
correct (e.g. best-effort cleanup racing teardown), suppress with a
comment saying which errors can arrive and why dropping them is safe.
"""

_BROAD = {"Exception", "BaseException"}
_LOG_HINTS = ("logger.", "logging.", "log.", "warnings.warn")
_LOG_LEAVES = {"exception", "warning", "error", "info", "debug",
               "critical", "print"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    def one(n):
        if isinstance(n, ast.Name):
            return n.id in _BROAD
        if isinstance(n, ast.Attribute):
            return n.attr in _BROAD
        return False
    if isinstance(t, ast.Tuple):
        return any(one(e) for e in t.elts)
    return one(t)


def _handled(handler: ast.ExceptHandler) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Raise):
            return True
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            if any(name.startswith(h) for h in _LOG_HINTS):
                return True
            if name.rsplit(".", 1)[-1] in _LOG_LEAVES:
                return True
        if handler.name and isinstance(sub, ast.Name) and \
                sub.id == handler.name and isinstance(sub.ctx, ast.Load):
            return True
    return False


def check_project(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.gang_paths():
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _handled(node):
                continue
            if src.is_node_suppressed(RULE, node):
                continue
            caught = "bare except" if node.type is None else \
                f"except {ast.unparse(node.type)}"
            out.append(src.violation(
                RULE, node,
                f"{caught} in a gang path swallows "
                f"GangMemberDiedError/RayActorError silently (no raise, "
                f"no log, bound error unused) — poison detection dies "
                f"here"))
    return out
