"""stale-suppression: a ``# raylint: disable[-next]=<rule>`` whose rule
no longer fires on its line — the suppression inventory may only
shrink."""

from __future__ import annotations

from typing import List

from ray_tpu_torch._private.lint.core import (
    Project,
    Violation,
    all_checkers,
)

RULE = "stale-suppression"

EXPLAIN = """\
stale-suppression — a ``# raylint: disable=<rule>`` /
``# raylint: disable-next=<rule>`` comment whose rule did not fire on
its line this run. Either the underlying code was fixed (delete the
comment — it is now a false claim about the code), the comment drifted
away from the line it used to annotate (line churn moved the code but
not the comment), or the rule name is misspelled/unknown (the comment
never suppressed anything and a real finding may be silently absent).

Why it matters here: every suppression is a reviewed exception to an
invariant ("this unbounded recv is a dedicated reader thread"). The
inventory of exceptions is part of the control plane's correctness
story — the original findings were triaged down to reasoned
suppressions, and this rule is the ratchet that keeps that set honest:
suppressions can only be removed or re-justified, never silently
accumulate as dead weight that hides future regressions on the same
line.

Mechanics: checkers record which (line, rule) suppressions actually
absorbed a would-be finding; this rule runs LAST and flags declared
suppressions that were never consulted. Only rules that executed this
run are judged (a ``--rule``-filtered run cannot see other rules'
hits), except unknown rule names, which are always findings.

Fix: delete the stale comment. If the finding it used to cover moved,
move the comment to the new line with its justification.
"""


def check_project(project: Project) -> List[Violation]:
    executed = project.executed_rules
    known = {c.RULE for c in all_checkers()}
    out: List[Violation] = []
    for src in project.sources:
        for line in sorted(src.suppressions):
            for rule in sorted(src.suppressions[line]):
                if rule == RULE:
                    continue
                if rule not in known:
                    out.append(Violation(
                        RULE, src.rel, line,
                        f"suppression names unknown rule {rule!r} "
                        f"(misspelled? it never suppressed anything)",
                        src.line_text(line)))
                    continue
                if executed is not None and rule not in executed:
                    continue  # that checker did not run: cannot judge
                if (line, rule) not in src.suppression_hits:
                    out.append(Violation(
                        RULE, src.rel, line,
                        f"stale suppression: {rule} no longer fires "
                        f"here — delete the comment (or move it back "
                        f"to the line it was justifying)",
                        src.line_text(line)))
    return out
