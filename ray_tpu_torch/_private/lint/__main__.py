"""raylint CLI.

    python -m ray_tpu_torch._private.lint                 # lint vs baseline
    python -m ray_tpu_torch._private.lint --no-baseline   # raw violation list
    python -m ray_tpu_torch._private.lint --write-baseline
    python -m ray_tpu_torch._private.lint --explain lock-order
    python -m ray_tpu_torch._private.lint --list-rules
    python -m ray_tpu_torch._private.lint --json
    python -m ray_tpu_torch._private.lint --emit-lock-graph  # static graph JSON
    python -m ray_tpu_torch._private.lint --changed-only     # vs git merge-base

Exit codes: 0 clean (no non-baselined violations, no stale baseline
entries), 1 ratchet failure, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from ray_tpu_torch._private.lint import core


def _changed_files(root: str) -> set:
    """Repo-relative paths touched vs the merge-base with main, plus the
    working tree (staged and unstaged)."""
    out: set = set()

    def _git(*args: str) -> str:
        try:
            r = subprocess.run(["git", *args], cwd=root,
                               capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return ""
        return r.stdout if r.returncode == 0 else ""

    for ref in ("main", "master"):
        base = _git("merge-base", "HEAD", ref).strip()
        if base:
            out.update(_git("diff", "--name-only",
                            f"{base}..HEAD").splitlines())
            break
    out.update(_git("diff", "--name-only").splitlines())
    out.update(_git("diff", "--name-only", "--cached").splitlines())
    return {p.strip() for p in out if p.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch._private.lint",
        description="raylint: distributed-correctness static analysis "
                    "for the port's control plane")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the ray_tpu_torch "
                         "package)")
    ap.add_argument("--baseline", default=core.DEFAULT_BASELINE,
                    help="baseline file (default: the committed ratchet)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every violation, ignore the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current run "
                         "(only after FIXING violations — never to "
                         "absorb new ones)")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--explain", metavar="RULE",
                    help="print the rationale for one rule and exit")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output (includes the call "
                         "path for transitive findings)")
    ap.add_argument("--depth", type=int, default=None, metavar="N",
                    help="bound call-graph summary propagation to N "
                         "rounds (default: full fixed point; 1 "
                         "approximates the old one-call-deep pass)")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only violations in files changed vs "
                         "the git merge-base with main (summaries are "
                         "still built over the whole program, so "
                         "cross-module findings in changed files are "
                         "exact)")
    ap.add_argument("--emit-lock-graph", action="store_true",
                    help="print the static lock-order graph as JSON "
                         "(locks by creation site + ordered edges with "
                         "witness chains) and exit; diffed against "
                         "lockdep.witnessed_graph() at runtime")
    args = ap.parse_args(argv)

    checkers = {c.RULE: c for c in core.all_checkers()}

    if args.list_rules:
        for rule, c in sorted(checkers.items()):
            first = c.EXPLAIN.strip().splitlines()[0]
            print(f"{rule:22s} {first}")
        return 0

    if args.explain:
        c = checkers.get(args.explain)
        if c is None:
            print(f"unknown rule: {args.explain!r} (try --list-rules)",
                  file=sys.stderr)
            return 2
        print(c.EXPLAIN.rstrip())
        return 0

    if args.rule:
        unknown = [r for r in args.rule if r not in checkers]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    if args.emit_lock_graph:
        from ray_tpu_torch._private.lint import callgraph
        project = core.Project(core.collect_sources(args.paths or None),
                               depth=args.depth)
        print(json.dumps(callgraph.emit_lock_graph(project), indent=1))
        return 0

    violations = core.run_lint(args.paths or None,
                               rules=set(args.rule) if args.rule else None,
                               depth=args.depth)

    if args.write_baseline:
        core.save_baseline(violations, args.baseline)
        print(f"baseline written: {len(violations)} entr"
              f"{'y' if len(violations) == 1 else 'ies'} -> "
              f"{args.baseline}")
        return 0

    if args.no_baseline:
        new, stale = violations, []
    else:
        baseline = core.load_baseline(args.baseline)
        new, stale = core.diff_baseline(violations, baseline)

    if args.changed_only:
        changed = _changed_files(core.REPO_ROOT)
        new = [v for v in new if v.path in changed]
        stale = []

    if args.as_json:
        print(json.dumps({
            "violations": [dict(v.__dict__,
                                chain=list(v.chain) if v.chain else None)
                           for v in new],
            "stale_baseline": stale,
            "total_current": len(violations),
        }, indent=1))
    else:
        for v in new:
            print(v)
            for hop in (v.chain or ()):
                print(f"    via {hop}")
        for k in stale:
            print(f"STALE baseline entry (fixed? run --write-baseline): "
                  f"{k}")
        n_base = len(violations) - len(new)
        tail = f" ({n_base} baselined)" if n_base and not args.no_baseline \
            else ""
        print(f"raylint: {len(new)} violation"
              f"{'' if len(new) == 1 else 's'}, {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'}{tail}")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
