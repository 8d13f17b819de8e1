"""async-blocking: thread-blocking ops transitively reachable from
``async def`` bodies in the ingress tier — one blocked loop tick stalls
the whole front door."""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch._private.lint.callgraph import fid_str
from ray_tpu_torch._private.lint.core import (
    Project,
    Violation,
)

RULE = "async-blocking"

EXPLAIN = """\
async-blocking — a call that blocks a THREAD (``time.sleep``, sync
socket/subprocess ops, ``Future.result``, ``ray.get``, RPC round trips)
reachable from an ``async def`` body without an intervening ``await`` —
directly, or through any chain of sync helpers the whole-program call
graph resolves (an async handler that calls a helper module whose
function sleeps is a finding even though the sleep is a module away).

Why it matters here: the ingress proxy is ONE asyncio loop. Every
``async def`` handler shares it; a single blocking call inside any of
them freezes every in-flight request, every admission decision, and
every streaming pump until it returns — the front door is down, not one
request. This is why the proxy routes blocking work through
``run_in_executor`` (the ``_call_bounded`` pattern) instead of calling
handles inline.

Scope: ``ray_tpu_torch/serve/ingress/`` and ``ray_tpu_torch/serve/proxy.py`` — the
asyncio tier. (Sync code paths are covered by blocking-under-lock /
unbounded-wait.)

What counts as blocking in async context: the blocking-under-lock op
set (sleep / RPC / subprocess / socket / ``.result`` / ``.wait`` /
``.join``), with one sharpening — a BOUNDED wait still blocks the loop
(``fut.result(timeout=5)`` stalls every other request for up to 5s), so
timeouts do not discharge a finding here. Also flagged: transitively
acquiring a lock that is elsewhere held across blocking ops (a "hot"
lock) — the loop inherits whatever latency the lock's other holders
incur. Cold leaf locks (dict-op critical sections like a route-table
lock) are fine and not flagged.

What it does NOT flag: awaited calls (``await`` is the correct way to
wait on a loop), coroutine creation without await, nested ``def``s
(pool-submitted closures run on executor threads, not the loop), chains
whose terminal op carries this rule's suppression at the origin, and
chains through a declared loop-safe boundary — a
``raylint: disable=async-blocking`` on a function's ``def`` line says
"this function detects the loop at runtime and defers its blocking work
to an executor"; one declaration covers every async caller.

Fix: ``await loop.run_in_executor(pool, blocking_fn, ...)``, or use the
async native (``asyncio.sleep``, ``asyncio.wait_for``).
"""

_SCOPE_PREFIXES = ("ray_tpu_torch/serve/ingress/",)
_SCOPE_FILES = ("ray_tpu_torch/serve/proxy.py",)


def _in_scope(rel: str) -> bool:
    return rel.startswith(_SCOPE_PREFIXES) or rel in _SCOPE_FILES


def _boundary_suppressed(project: Project, cg, fid, item) -> bool:
    """True if any function on the witness chain declares itself
    loop-safe: a ``raylint: disable=async-blocking`` on its ``def`` line
    means "this function defers its blocking work off the loop when
    called from one" (runtime dispatch the static pass cannot follow —
    e.g. tracing's executor-deferred flush). One declaration at the API
    boundary covers every async caller; stale-suppression keeps it
    honest."""
    for f in cg.chain_fids(fid, item):
        finfo = cg.functions.get(f)
        if finfo is None:
            continue
        if finfo.src.suppressed(RULE, finfo.node.lineno):
            return True
    return False


def check_project(project: Project) -> List[Violation]:
    cg = project.callgraph()
    out: List[Violation] = []
    hot = None  # computed lazily: only if an async fn acquires a lock
    for src in project.sources:
        if not _in_scope(src.rel):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            fid = cg.fid_of(src, node)
            if fid is None:
                continue
            for item in sorted(cg.summary(fid)):
                if item[0] == "lock":
                    if hot is None:
                        hot = cg.hot_locks()
                    if item[1] not in hot:
                        continue  # cold leaf lock: dict-op held, fine
                if item[0] not in ("block", "lock"):
                    continue
                wit = cg._wit.get((fid, item))
                if wit is None:
                    continue
                # The flagged line is the first hop INSIDE this async fn:
                # the direct op, or the call that starts the chain.
                line = wit[2]
                anchor = wit[3] if wit[0] == "direct" else wit[5]
                origin = cg.origin(fid, item)
                if origin is not None:
                    orel, _oline, onode = origin
                    osrc = project.by_rel.get(orel)
                    if osrc is not None and \
                            osrc.is_node_suppressed(RULE, onode):
                        continue
                if _boundary_suppressed(project, cg, fid, item):
                    continue
                if src.is_node_suppressed(RULE, anchor) or \
                        src.suppressed(RULE, node.lineno):
                    continue
                chain = cg.chain(fid, item)
                if item[0] == "block":
                    msg = (f"async def {node.name}() reaches blocking "
                           f"{item[1]}(...) with no await in between: "
                           f"one loop tick blocked stalls every "
                           f"in-flight request")
                else:
                    hrel, hline, hdesc = hot[item[1]]
                    msg = (f"async def {node.name}() acquires {item[1]}, "
                           f"which is held across blocking work at "
                           f"{hrel}:{hline} ({hdesc}): the loop inherits "
                           f"that latency")
                out.append(Violation(
                    RULE, src.rel, line, msg, src.line_text(line),
                    chain=tuple(chain) or None))
    return out
