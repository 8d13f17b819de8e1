"""raylint core: source model, suppression parsing, baseline ratchet.

Design notes
------------
- Pure ``ast`` + ``tokenize``; no torch / no runtime imports of the linted
  modules, so tier-1 can run this without an accelerator stack.
- A violation's identity is ``rule::path::snippet`` (the stripped source
  line), NOT the line number — line churn from unrelated edits must not
  invalidate the baseline.
- Suppressions are explicit and must carry the rule name:
  ``# raylint: disable=<rule>[,<rule>...]`` on the flagged line (or the
  first line of the enclosing statement), or
  ``# raylint: disable-next=<rule>`` on the preceding line. A bare
  ``disable`` (no rule) is deliberately NOT honored: the tool ships
  trusted, not muted.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# Repo root = parent of the ray_tpu_torch package directory.
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_ROOT = os.path.dirname(_PKG_DIR)

# Modules forming the control plane: daemon loops, supervisors, the
# collective/gang layer, and the scheduler. The wait/lock/exception
# checkers are scoped here — a missing timeout in a CLI helper is noise;
# in a daemon or a collective it wedges a node or a gang.
CONTROL_PLANE = (
    "ray_tpu_torch/_private/node_manager.py",
    "ray_tpu_torch/_private/gcs.py",
    "ray_tpu_torch/_private/lease.py",
    "ray_tpu_torch/_private/worker.py",
    "ray_tpu_torch/_private/worker_main.py",
    "ray_tpu_torch/_private/protocol.py",
    # The sampling profiler runs a daemon thread inside EVERY process
    # of the cluster and answers over control-plane listener threads —
    # an unbounded wait or a lock inversion here wedges the very
    # process someone is trying to diagnose.
    "ray_tpu_torch/_private/profiler.py",
    "ray_tpu_torch/_private/device_objects.py",
    # The shm submit ring: its drain thread runs inside every node
    # manager and its writer is called from arbitrary driver threads —
    # a blocking call under its lock or an unbounded park here stalls
    # the submit pipeline of a whole client.
    "ray_tpu_torch/_private/submit_ring.py",
    # The shm completion ring: its consumer loop runs inside every
    # driver and its producer is called from the NM's task_done path
    # under a per-ring lock — an unbounded park or a blocking call
    # under that lock stalls completion delivery for a whole node.
    "ray_tpu_torch/_private/completion_ring.py",
    # The factored SPSC core under BOTH rings and the worker
    # completion segments: its park/bell/heartbeat discipline is the
    # liveness contract of every shm transport — an unbounded park or
    # a blocking call under its append lock stalls submit AND
    # completion delivery everywhere at once.
    "ray_tpu_torch/_private/shm_ring.py",
    # The inline-object tables back every get()/deserialize_args and
    # sit under the GCS object shard and the lease completion handler —
    # a blocking call under their leaf locks would invert the whole
    # result-return pipeline's lock graph.
    "ray_tpu_torch/_private/inline_objects.py",
    "ray_tpu_torch/parallel/collective.py",
    "ray_tpu_torch/train/worker_group.py",
    # The LLM serving tier: the engine's scheduler thread and the
    # router's pool fan-out are daemon paths — an unbounded wait there
    # wedges every request parked on the replica.
    "ray_tpu_torch/serve/llm/engine.py",
    "ray_tpu_torch/serve/llm/replicas.py",
    "ray_tpu_torch/serve/llm/router.py",
    "ray_tpu_torch/serve/llm/kv_transfer.py",
    "ray_tpu_torch/serve/llm/paged.py",
    # The HTTP ingress: every ingress->handle hop must be bounded — a
    # parked proxy thread is one of a BOUNDED pool, so an unbounded
    # wait doesn't just wedge one request, it shrinks the front door.
    "ray_tpu_torch/serve/ingress/server.py",
    "ray_tpu_torch/serve/ingress/admission.py",
    # The serve fault-tolerance spine: the controller's reconcile/drain
    # loops, the replica's drain wait, and the handle/migration resume
    # path all run in daemon threads between a dying replica and its
    # replacement — an unbounded wait here turns a crash the tier is
    # built to absorb into a wedged request.
    "ray_tpu_torch/serve/controller.py",
    "ray_tpu_torch/serve/replica.py",
    "ray_tpu_torch/serve/handle.py",
    "ray_tpu_torch/serve/migration.py",
    # The GCS launcher supervises the out-of-process GCS from inside
    # init()/shutdown() — its bootstrap poll and terminate/kill waits
    # gate every cluster start and teardown.
    "ray_tpu_torch/_private/gcs_launcher.py",
    # The spec-template byte patcher runs on the worker-submit hot path
    # (every classic submit rides a patched template).
    "ray_tpu_torch/_private/spec_template.py",
    # The dashboard agent's collectors run daemon threads inside every
    # NM and fan in over control-plane sockets.
    "ray_tpu_torch/dashboard/agent.py",
    # Back-compat ingress shim (re-exports the HTTP proxy).
    "ray_tpu_torch/serve/proxy.py",
    # The asyncio HTTP server under both the serve ingress and the
    # dashboard head: its accept loop and handlers are the front door of
    # each, so a wait here parks every request behind it.
    "ray_tpu_torch/_private/http.py",
)

# The subset where a swallowed GangMemberDiedError / RayActorError turns
# a bounded failure into a silent wedge (gang + supervisor paths).
GANG_PATHS = (
    "ray_tpu_torch/parallel/collective.py",
    "ray_tpu_torch/train/worker_group.py",
    "ray_tpu_torch/train/data_parallel.py",
)

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

_SUPPRESS_RE = re.compile(
    r"#\s*raylint:\s*(disable-next|disable)\s*=\s*"
    r"([a-z0-9_-]+(?:\s*,\s*[a-z0-9_-]+)*)")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative, '/'-separated
    line: int          # 1-based, for display only
    message: str
    snippet: str       # stripped source of the flagged line
    # Witness call path for transitive (call-graph) findings: one hop per
    # entry, the concrete op last. Display-only — NOT part of the
    # baseline key (resolution improvements must not invalidate it).
    chain: Optional[Tuple[str, ...]] = None

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.snippet}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Source:
    """One parsed python file with parent links and suppression map."""

    def __init__(self, abspath: str, rel: str, text: str):
        self.abspath = abspath
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        self.modname = rel[:-3].replace("/", ".")
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._raylint_parent = node  # type: ignore[attr-defined]
        self.suppressions = self._parse_suppressions(text)
        # (line, rule) pairs that actually suppressed a would-be finding
        # this run — the stale-suppression checker flags the rest.
        self.suppression_hits: Set[Tuple[int, str]] = set()

    def _parse_suppressions(self, text: str) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        lines = text.splitlines()

        def next_code_line(after: int) -> int:
            """1-based line of the next non-blank, non-comment line —
            ``disable-next`` over a multi-line comment applies to the
            statement the comment block annotates."""
            i = after  # 0-based index of the line after the comment
            while i < len(lines):
                stripped = lines[i].strip()
                if stripped and not stripped.startswith("#"):
                    return i + 1
                i += 1
            return after + 1

        try:
            toks = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
                line = tok.start[0]
                if m.group(1) == "disable-next":
                    line = next_code_line(line)
                out.setdefault(line, set()).update(rules)
        except tokenize.TokenError:
            pass
        return out

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, *linenos: int) -> bool:
        for ln in linenos:
            if rule in self.suppressions.get(ln, ()):
                self.suppression_hits.add((ln, rule))
                return True
        return False

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_raylint_parent", None)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing(self, node: ast.AST, *types) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, types):
                return anc
        return None

    def enclosing_function(self, node: ast.AST):
        return self.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        return self.enclosing(node, ast.ClassDef)

    def violation(self, rule: str, node: ast.AST, message: str,
                  chain: Optional[Sequence[str]] = None) -> Violation:
        line = getattr(node, "lineno", 1)
        return Violation(rule=rule, path=self.rel, line=line,
                         message=message, snippet=self.line_text(line),
                         chain=tuple(chain) if chain else None)

    def is_node_suppressed(self, rule: str, node: ast.AST,
                           *extra_nodes: ast.AST) -> bool:
        """Suppression may sit on the flagged line or on the first line
        of any enclosing `with` / `try` / statement header."""
        lines = [getattr(node, "lineno", 0)]
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.With, ast.Try, ast.stmt)):
                lines.append(getattr(anc, "lineno", 0))
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
        for n in extra_nodes:
            lines.append(getattr(n, "lineno", 0))
        return self.suppressed(rule, *lines)


# --------------------------------------------------------------- ast helpers

def call_name(node: ast.AST) -> str:
    """Dotted name of a call target: ``ray.get`` / ``self._lock.acquire``.
    Unresolvable pieces become ``?``."""
    if isinstance(node, ast.Call):
        node = node.func
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append("()")
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def has_kw(call: ast.Call, *names: str) -> bool:
    return any(kw.arg in names for kw in call.keywords)


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<unparse-failed>"


def walk_calls(node: ast.AST) -> Iterable[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


# ------------------------------------------------------------------- project

class Project:
    """The linted file set plus lazily-built cross-file indices.

    ``depth`` bounds the call-graph summary propagation (None = full
    fixed point; 1 = one call deep, the pre-callgraph behavior).
    """

    def __init__(self, sources: List[Source],
                 depth: Optional[int] = None):
        self.sources = sources
        self.depth = depth
        self.by_rel = {s.rel: s for s in sources}
        self._lock_registry: Optional[Dict[str, dict]] = None
        self._callgraph = None
        # Rules actually executed this run (set by run_lint) — the
        # stale-suppression checker only judges suppressions of rules
        # that ran.
        self.executed_rules: Optional[Set[str]] = None
        # (rel, line, attr) -> {"candidates": [...], "text": str, "node"}
        # — lock attribute references that matched multiple classes and
        # receiver-type inference could not disambiguate (reported by
        # the lock-ambiguous rule).
        self.ambiguous_locks: Dict[Tuple[str, int, str], dict] = {}

    def callgraph(self):
        if self._callgraph is None:
            from ray_tpu_torch._private.lint.callgraph import CallGraph
            self._callgraph = CallGraph(self, depth=self.depth)
        return self._callgraph

    def control_plane(self) -> List[Source]:
        return [s for s in self.sources if s.rel in CONTROL_PLANE]

    def gang_paths(self) -> List[Source]:
        return [s for s in self.sources if s.rel in GANG_PATHS]

    # ---- lock registry: every `x = threading.Lock()/RLock()/...` site

    _LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": True,
                   "Semaphore": False, "BoundedSemaphore": False,
                   # _thread.allocate_lock(): lockdep's own un-wrapped
                   # state lock — registered so the static graph's edges
                   # into it reference a known creation site.
                   "allocate_lock": False}

    def lock_registry(self) -> Dict[str, dict]:
        """lock_id -> {"reentrant": bool, "source": rel, "line": int,
        "attr": short name}. lock_id is ``module.Class._attr`` for
        instance locks, ``module._name`` for module/local locks."""
        if self._lock_registry is None:
            reg: Dict[str, dict] = {}
            for src in self.sources:
                for node in ast.walk(src.tree):
                    if not isinstance(node, ast.Assign):
                        continue
                    val = node.value
                    if not isinstance(val, ast.Call):
                        continue
                    ctor = call_name(val).rsplit(".", 1)[-1]
                    if ctor not in self._LOCK_CTORS:
                        continue
                    # Condition() wraps an RLock; Condition(lock) wraps
                    # that lock — either way the with-block is reentrant
                    # only if the underlying lock is.
                    reentrant = self._LOCK_CTORS[ctor]
                    for tgt in node.targets:
                        text = unparse(tgt)
                        if text.startswith("self."):
                            cls = src.enclosing_class(node)
                            cname = cls.name if cls else "?"
                            lid = f"{src.modname}.{cname}.{text[5:]}"
                            attr = text[5:]
                        else:
                            lid = f"{src.modname}.{text}"
                            attr = text
                        reg[lid] = {"reentrant": reentrant,
                                    "source": src.rel,
                                    "line": node.lineno,
                                    "attr": attr}
            self._lock_registry = reg
        return self._lock_registry

    def resolve_lock(self, src: Source, expr: ast.AST,
                     ctx_node: ast.AST) -> Optional[str]:
        """Map a with-item context expression to a registered lock id,
        or a heuristic id when the name smells like a lock but has no
        registered creation site. None = not a lock."""
        reg = self.lock_registry()
        text = unparse(expr)
        if text.startswith("self."):
            cls = src.enclosing_class(ctx_node)
            if cls is not None:
                lid = f"{src.modname}.{cls.name}.{text[5:]}"
                if lid in reg:
                    return lid
        if isinstance(expr, ast.Name):
            lid = f"{src.modname}.{text}"
            if lid in reg:
                return lid
        if isinstance(expr, ast.Attribute):
            # `mod._lock`: a module-level lock referenced through an
            # import resolves to its registered creation site.
            recv = unparse(expr.value)
            if recv and "." not in recv and not recv.startswith("self"):
                tmod = self.callgraph()._resolve_module(
                    recv, self.callgraph().canonical(src.modname))
                if tmod is not None:
                    lid = f"{tmod}.{expr.attr}"
                    if lid in reg:
                        return lid
            # `other._lock`: match by attribute name across classes, then
            # disambiguate with the call graph's receiver-type inference.
            # A site inference cannot pin down is reported under the
            # lock-ambiguous rule and gets a site-scoped identity — it
            # must NOT conflate distinct locks into one graph node.
            matches = [lid for lid, info in reg.items()
                       if info["attr"] == expr.attr]
            if len(matches) == 1:
                return matches[0]
            if matches:
                cg = self.callgraph()
                types = cg.infer_expr_types(src, expr.value, ctx_node)
                cands = []
                for t in types:
                    for c in cg._mro(t):
                        lid = f"{c[0]}.{c[1]}.{expr.attr}"
                        if lid in reg and lid not in cands:
                            cands.append(lid)
                if len(cands) == 1:
                    return cands[0]
                self.ambiguous_locks.setdefault(
                    (src.rel, getattr(expr, "lineno", 0), expr.attr),
                    {"text": text, "node": expr,
                     "candidates": sorted(cands or matches)})
                return f"{src.modname}:{text}"
        low = text.lower()
        if "lock" in low or low.endswith("_cv") or low in ("cv", "cond"):
            return f"{src.modname}:{text}"
        return None

    def lock_is_reentrant(self, lock_id: str) -> bool:
        info = self.lock_registry().get(lock_id)
        return bool(info and info["reentrant"])


# ----------------------------------------------------------------- discovery

_EXCLUDE_DIRS = {"__pycache__"}
# The linter does not lint itself (its fixtures would trip it) — but the
# exclusion is the linter's OWN package path, not any directory that
# happens to be named `lint` (a future ray_tpu_torch/<pkg>/lint/ must be
# linted like everything else).
_LINT_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def collect_sources(paths: Optional[Sequence[str]] = None,
                    root: str = REPO_ROOT) -> List[Source]:
    """Parse every .py under ``paths`` (default: the ray_tpu_torch package)."""
    files: List[str] = []
    for p in (paths or [os.path.join(root, "ray_tpu_torch")]):
        p = os.path.abspath(p)
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in _EXCLUDE_DIRS and
                os.path.join(dirpath, d) != _LINT_PKG_DIR)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    files.append(os.path.join(dirpath, fn))
    sources = []
    for f in files:
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        try:
            with open(f, "r", encoding="utf-8") as fh:
                text = fh.read()
            sources.append(Source(f, rel, text))
        except (OSError, SyntaxError, UnicodeDecodeError):
            continue
    return sources


# -------------------------------------------------------------------- runner

def all_checkers():
    from ray_tpu_torch._private.lint.checkers import (
        async_blocking,
        blocking_under_lock,
        config_drift,
        exception_swallow,
        hold_release,
        lock_ambiguous,
        lock_order,
        stale_suppression,
        unbounded_wait,
    )
    # stale_suppression MUST run last: it judges which suppressions the
    # other checkers actually consulted this run.
    return [unbounded_wait, blocking_under_lock, lock_order,
            lock_ambiguous, async_blocking, hold_release,
            exception_swallow, config_drift, stale_suppression]


def run_lint(paths: Optional[Sequence[str]] = None,
             root: str = REPO_ROOT,
             rules: Optional[Set[str]] = None,
             depth: Optional[int] = None) -> List[Violation]:
    project = Project(collect_sources(paths, root=root), depth=depth)
    project.executed_rules = set()
    violations: List[Violation] = []
    for checker in all_checkers():
        if rules and checker.RULE not in rules:
            continue
        project.executed_rules.add(checker.RULE)
        violations.extend(checker.check_project(project))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations


# ------------------------------------------------------------------ baseline

def load_baseline(path: str = DEFAULT_BASELINE) -> Dict[str, int]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return {}
    return {str(k): int(v) for k, v in blob.get("entries", {}).items()}


def save_baseline(violations: Iterable[Violation],
                  path: str = DEFAULT_BASELINE) -> None:
    entries: Dict[str, int] = {}
    for v in violations:
        entries[v.key] = entries.get(v.key, 0) + 1
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1,
                   "comment": "raylint debt ratchet: counts may only "
                              "decrease. Regenerate with "
                              "`python -m ray_tpu_torch._private.lint "
                              "--write-baseline` AFTER fixing, never to "
                              "absorb a new violation.",
                   "entries": dict(sorted(entries.items()))},
                  f, indent=1, sort_keys=False)
        f.write("\n")


def diff_baseline(violations: List[Violation],
                  baseline: Dict[str, int]
                  ) -> Tuple[List[Violation], List[str]]:
    """Returns (new_violations, stale_baseline_keys). The ratchet fails
    on either: new debt is a regression; stale entries mean a fix landed
    without shrinking the baseline (run --write-baseline)."""
    counts: Dict[str, int] = {}
    new: List[Violation] = []
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
        if counts[v.key] > baseline.get(v.key, 0):
            new.append(v)
    stale = [k for k, n in baseline.items() if counts.get(k, 0) < n]
    return new, stale
