"""blocking-under-lock: RPCs / sleeps / subprocess / socket ops inside a
``with <lock>:`` body, directly or transitively through the whole-program
call graph."""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch._private.lint.callgraph import fid_str
from ray_tpu_torch._private.lint.core import (
    Project,
    Violation,
    unparse,
)

RULE = "blocking-under-lock"

EXPLAIN = """\
blocking-under-lock — a call that can block on the outside world (RPC
round trip, sleep, subprocess spawn/wait, raw socket I/O, future/thread
wait) executed while holding a lock, either directly in the ``with``
body or transitively through any chain of calls the whole-program call
graph can resolve (cross-module included — a GCS handler holding
``_obj_lock`` that calls through ``inline_objects`` into a socket send
is a finding even though the blocking op is two modules away).

Why it matters here: this is the exact shape of the r7 deferred-reply
hang. A node-manager handler held the pool lock across work that waited
on a worker process; the worker needed a message the locked thread would
have delivered; every other thread then piled up behind the lock — a
single slow process turned into a node-wide wedge. Under a lock, latency
is not additive, it is multiplicative: every waiter inherits it.

What it flags inside a with-lock body: ``time.sleep``, ``ray.get``,
``.request(...)`` RPCs, ``subprocess.*`` / ``Popen``,
``.communicate``/``.wait``/``.join``/``.result``, socket
``connect/sendall/recv/recv_into/accept`` — reached directly or via any
resolvable callee chain (the violation carries the witness path; see
``--json``).

What it deliberately does NOT flag:
- ``conn.notify`` / ``conn.reply`` / ``reply_error`` — the protocol
  layer queues these to a writer thread (inline fast path is
  MSG_DONTWAIT), so they cannot block on a full socket buffer.
- ``cv.wait()`` inside ``with cv:`` — the Condition idiom RELEASES the
  lock while waiting; that is the correct way to wait.
- ``proc.kill()`` / ``os.kill`` — signal sends, non-blocking.
- chains whose terminal op carries a ``raylint: disable`` for this rule
  at the op site — a reasoned suppression at the origin covers every
  caller.

Fix: move the blocking call out of the critical section (snapshot state
under the lock, act outside — see _acquire_gpus's victim-kill pattern),
or bound it and suppress with a comment explaining why holding the lock
across it is safe.
"""


def check_project(project: Project) -> List[Violation]:
    cg = project.callgraph()
    out: List[Violation] = []
    for src in project.control_plane():
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.With):
                continue
            lock_items = [(item, project.resolve_lock(src,
                                                      item.context_expr,
                                                      node))
                          for item in node.items]
            lock_items = [(i, lid) for i, lid in lock_items
                          if lid is not None]
            if not lock_items:
                continue
            lock_texts = {unparse(i.context_expr) for i, _ in lock_items}
            lock_desc = ", ".join(sorted(lock_texts))
            for call, how in cg.blocking_in_with(src, node, lock_texts):
                if src.is_node_suppressed(RULE, call, node):
                    continue
                if how[0] == "direct":
                    out.append(src.violation(
                        RULE, call,
                        f"{how[1]}(...) while holding {lock_desc}: "
                        f"every thread queueing on the lock inherits "
                        f"this call's latency"))
                    continue
                _, callee, item = how
                origin = cg.origin(callee, item)
                if origin is not None:
                    orel, _oline, onode = origin
                    osrc = project.by_rel.get(orel)
                    if osrc is not None and \
                            osrc.is_node_suppressed(RULE, onode):
                        continue  # reasoned suppression at the op site
                chain = ([f"{src.rel}:{call.lineno}: holds {lock_desc}, "
                          f"calls {fid_str(callee)}"]
                         + cg.chain(callee, item))
                out.append(src.violation(
                    RULE, call,
                    f"call to {fid_str(callee)}() while holding "
                    f"{lock_desc} blocks via {item[1]} "
                    f"({chain[-1].rsplit(': ', 1)[0]})",
                    chain=chain))
    return out
