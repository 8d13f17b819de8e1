"""lock-ambiguous: a lock-typed attribute reference that receiver-type
inference cannot pin to one creation site — its edges would conflate
distinct locks in the order graph."""

from __future__ import annotations

from typing import List

from ray_tpu_torch._private.lint.core import (
    Project,
    Violation,
)

RULE = "lock-ambiguous"

EXPLAIN = """\
lock-ambiguous — a ``with other._lock:`` (or ``._lock.acquire()``) whose
receiver could be any of several classes that each define a ``_lock``,
and the call graph's receiver-type inference (parameter annotations,
``self._attr = Ctor(...)`` assignments, local ``x = Ctor(...)``) could
not narrow it to one. Lock identity is the creation site; a reference
that cannot be resolved to one site either pollutes the static
lock-order graph with a conflated node (the pre-callgraph behavior:
every ``_lock``-defining class collapsed into ``?._lock``) or — the
current behavior — gets a site-scoped identity that the order graph
cannot connect to the real lock's other edges. Both are blind spots:
an inversion through this site would go unseen by the static half of
lockdep, surviving until the runtime witness happens to execute it.

Fix: give the receiver a type the inference can see — an annotation on
the parameter (``def f(nm: NodeManager)``), a constructor assignment on
the attribute, or rename the lock attribute to be unique. If the site
is genuinely polymorphic (same attribute protocol across classes),
suppress with a comment saying which classes flow here and why their
lock order is uniform.
"""


def check_project(project: Project) -> List[Violation]:
    # Force the project-wide lock-graph build so every with-site and
    # manual acquire region has been through resolve_lock (standalone
    # --rule=lock-ambiguous runs must not depend on lock-order having
    # run first).
    project.callgraph().lock_graph()
    out: List[Violation] = []
    for (rel, line, attr), info in sorted(project.ambiguous_locks.items()):
        src = project.by_rel.get(rel)
        if src is None:
            continue
        if src.is_node_suppressed(RULE, info["node"]):
            continue
        cands = ", ".join(info["candidates"][:4])
        more = len(info["candidates"]) - 4
        if more > 0:
            cands += f" (+{more} more)"
        out.append(Violation(
            RULE, rel, line,
            f"{info['text']} could be any of [{cands}]: receiver type "
            f"unknown, so this site's lock edges don't connect to the "
            f"real lock's order graph",
            src.line_text(line)))
    return out
