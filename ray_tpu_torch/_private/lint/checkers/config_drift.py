"""config-knob-drift: raw RAY_TPU_* env reads outside the typed config
registry."""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch._private.lint.core import Project, Violation, call_name, unparse

RULE = "config-knob-drift"

EXPLAIN = """\
config-knob-drift — a raw ``os.environ`` / ``os.getenv`` read of a
``RAY_TPU_*`` key anywhere outside ``_private/config.py``.

Why it matters: the typed registry (reference: the RAY_CONFIG macro
registry, src/ray/common/ray_config_def.h) is what makes a knob real —
typed default, documented tradeoff, cluster-wide JSON override, and one
place to grep. A raw ``os.environ.get("RAY_TPU_FOO")`` bypasses all
four: it silently returns a string where the code wants an int, ignores
``apply_system_config`` blobs shipped at node start, never shows up in
``config.dump()`` diagnostics, and drifts — the same knob read in two
modules with two different defaults is a bug nobody assigned.

What it flags: reads only (``os.environ.get``, ``os.getenv``,
``os.environ["RAY_TPU_..."]`` loads). Writes are spawner→child plumbing
(the node manager composing a worker's environment) and are fine.

The legitimate exception: per-process BOOTSTRAP identity the spawner
hands the child (worker id, node id, store path, NM/GCS addresses,
session dir, zygote socket). Those are not knobs — they change per
process after the config module was already imported, so routing them
through the registry would read stale values in forked workers.
Suppress those with a comment saying "bootstrap identity".

Fix: ``config.define(...)`` the knob in ``_private/config.py`` with a
default and a doc sentence, then read ``config.<name>``.
"""


def _env_key(node: ast.Call) -> Optional[str]:
    name = call_name(node)
    if name in ("os.environ.get", "os.getenv", "environ.get", "getenv"):
        if node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            return node.args[0].value
    return None


def check_project(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.sources:
        if src.rel.endswith("_private/config.py"):
            continue
        for node in ast.walk(src.tree):
            key = None
            if isinstance(node, ast.Call):
                key = _env_key(node)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    unparse(node.value) == "os.environ" and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                key = node.slice.value
            if not key or not key.startswith("RAY_TPU_"):
                continue
            if src.is_node_suppressed(RULE, node):
                continue
            out.append(src.violation(
                RULE, node,
                f"raw env read of {key} bypasses the typed config "
                f"registry (_private/config.py): no typed default, no "
                f"system-config override, invisible to config.dump()"))
    return out
