"""lock-order: build the static lock-acquisition graph from nested
``with`` scopes and transitive call-graph acquisition summaries, and
report cycles + non-reentrant self-nesting."""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.lint.core import (
    Project,
    Violation,
)

RULE = "lock-order"

EXPLAIN = """\
lock-order — the static half of lockdep. Every ``with <lock>:`` nested
inside another ``with <lock>:`` — syntactically, or through ANY chain of
calls the whole-program call graph resolves (cross-module helpers,
``self.``-dispatch, attribute receivers), or inside a manual
``.acquire()``/``.release()`` region — contributes an edge outer→inner
to a global lock-acquisition graph spanning every lock site in the
repo. A cycle in that graph is a deadlock waiting for the right
interleaving: thread 1 holds A wanting B while thread 2 holds B wanting
A. Unlike a data race this never shows up in single-threaded tests —
only under production concurrency, as a silent wedge.

Also flagged: nesting a NON-reentrant ``threading.Lock`` inside itself
(directly or via any resolvable call chain that re-acquires it) — that
one deadlocks on the first execution of the path, no interleaving
needed.

Lock identity is the creation site (``Class._attr`` / module global),
i.e. lockdep "classes", so per-instance locks of the same class are one
node — two NodeManagers' ``_lock``s never order against each other in
one process, but A→B through one instance and B→A through another is
still the same latent cycle.

The runtime twin: ``ray_tpu_torch._private.lockdep`` (knob
RAY_TPU_TORCH_LOCKDEP_ENABLED) wraps threading.Lock/RLock, records the ACTUAL
acquisition order, and dumps the witness cycle — it catches orders the
static view can't see (callbacks, function-valued dispatch); this
checker catches orders the tests never execute. Run both — and diff
them: ``--emit-lock-graph`` exports this graph as JSON, and the
reconciliation test fails on any runtime edge the static graph lacks.

Fix: pick one global order and restructure (snapshot under one lock,
act under the other), or collapse the two locks into one.
"""

Edge = Tuple[str, str]


def check_project(project: Project) -> List[Violation]:
    cg = project.callgraph()
    violations: List[Violation] = []

    for lid, src, node, line, how, chain in cg.self_nests():
        if project.lock_is_reentrant(lid) or lid.startswith("?") or \
                ":" in lid:
            continue
        if src.is_node_suppressed(RULE, node):
            continue
        violations.append(Violation(
            RULE, src.rel, line,
            f"non-reentrant lock {lid} re-acquired while held ({how}): "
            f"deadlocks on first execution",
            src.line_text(line), chain=tuple(chain) or None))

    # (outer, inner) -> (rel, line, how, chain) for the first sighting.
    edges = cg.lock_graph()
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    def find_cycle_through(start: str) -> Optional[List[str]]:
        stack = [(start, [start])]
        seen: Set[str] = set()
        while stack:
            cur, path = stack.pop()
            for nxt in graph.get(cur, ()):
                if nxt == start:
                    return path + [start]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    reported: Set[frozenset] = set()
    for a in sorted(graph):
        cyc = find_cycle_through(a)
        if cyc is None:
            continue
        key = frozenset(cyc)
        if key in reported:
            continue
        reported.add(key)
        sites = []
        chain: List[str] = []
        sup = False
        for i in range(len(cyc) - 1):
            e = edges.get((cyc[i], cyc[i + 1]))
            if e is not None:
                esrc = project.by_rel.get(e[0])
                if esrc is not None and esrc.suppressed(RULE, e[1]):
                    # A reasoned suppression on ANY edge of the cycle
                    # dismisses the whole witness (the justification —
                    # e.g. a gate lock serializing both paths — is about
                    # the cycle, not one edge).
                    sup = True
                sites.append(f"{cyc[i]}→{cyc[i + 1]} at "
                             f"{e[0]}:{e[1]} ({e[2]})")
                chain.extend(e[3])
        if sup:
            continue
        rel0, line0, _, _ = edges[(cyc[0], cyc[1])]
        src0 = project.by_rel.get(rel0)
        violations.append(Violation(
            RULE, rel0, line0,
            "lock-order cycle (deadlock witness): " + "; ".join(sites),
            src0.line_text(line0) if src0 else "",
            chain=tuple(chain) or None))
    return violations
