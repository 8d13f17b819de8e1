"""Logical plan + optimizer for Data (port of ``ray_tpu/data/logical.py``;
reference:
``python/ray/data/_internal/logical/`` — operators.py's LogicalOperator
tree, rules/operator_fusion.py, rules/limit_pushdown.py; the planner
lowers the optimized logical plan to physical execution).

The API surface builds LOGICAL operators; optimization rules rewrite the
operator chain; lowering produces the fused physical stages the
executors run. Rules here:

- **OperatorFusion**: adjacent per-block operators (map / flat_map /
  filter / map_batches / block transforms) fuse into one physical stage
  group → one task per block regardless of chain length (reference:
  rules/operator_fusion.py).
- **LimitPushdown**: a Limit below only-row-preserving-or-shrinking
  operators moves toward the source, so execution stops launching block
  tasks once the limit is satisfied (reference: rules/limit_pushdown.py).
- **ProjectionPushdown**: a SelectColumns immediately after another
  SelectColumns collapses; a projection adjacent to the source is
  annotated for readers that support column pruning (reference:
  Parquet projection pushdown).

``Dataset.explain()`` prints the logical chain and the physical plan it
lowers to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class LogicalOp:
    """One logical operator. ``kind`` is the physical lowering class:
    row | batch | block (fusable) or limit (control)."""

    name: str                 # e.g. "Map", "Filter", "MapBatches", "Limit"
    kind: str
    fn: Optional[Callable] = None
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        extra = ""
        if self.name == "Limit":
            extra = f"[{self.kwargs.get('limit')}]"
        elif self.name == "SelectColumns":
            extra = f"[{self.kwargs.get('cols')}]"
        return f"{self.name}{extra}"


FUSABLE = ("row", "batch", "block")


class Rule:
    name = "rule"

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        raise NotImplementedError


class LimitPushdown(Rule):
    """Move Limit below operators that never grow the row count per
    input row consumed (map-like and filter ops): the executor can then
    stop scheduling block tasks as soon as enough rows exist. Ops that
    may EXPAND rows (flat_map, arbitrary map_batches) block the push."""

    name = "LimitPushdown"

    # One-to-one ops only: Filter SHRINKS rows, so pushing a limit
    # below it would change WHICH rows satisfy the limit.
    _ROW_PRESERVING = {"Map", "SelectColumns", "DropColumns", "AddColumn"}

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        ops = list(ops)
        changed = True
        while changed:
            changed = False
            for i in range(1, len(ops)):
                if ops[i].name == "Limit" and \
                        ops[i - 1].name in self._ROW_PRESERVING:
                    ops[i - 1], ops[i] = ops[i], ops[i - 1]
                    changed = True
        return ops


class ProjectionPushdown(Rule):
    """Collapse adjacent projections (narrower set wins)."""

    name = "ProjectionPushdown"

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        out: List[LogicalOp] = []
        for op in ops:
            if (op.name == "SelectColumns" and out
                    and out[-1].name == "SelectColumns"):
                prev = set(out[-1].kwargs["cols"])
                cols = [c for c in op.kwargs["cols"] if c in prev]
                out[-1] = dataclasses.replace(
                    out[-1],
                    fn=(lambda cc: lambda r: [{k: r[k] for k in cc}])(
                        cols),
                    kwargs={**out[-1].kwargs, "cols": cols})
                continue
            out.append(op)
        return out


class OperatorFusion(Rule):
    """Group runs of fusable operators; each group lowers to ONE
    physical stage pipeline executed as one task per block."""

    name = "OperatorFusion"

    def apply(self, ops: List[LogicalOp]) -> List[LogicalOp]:
        return ops   # fusion happens at lowering; rule kept for explain


DEFAULT_RULES: List[Rule] = [ProjectionPushdown(), LimitPushdown(),
                             OperatorFusion()]


def optimize(ops: List[LogicalOp],
             rules: Optional[List[Rule]] = None) -> List[LogicalOp]:
    for rule in rules if rules is not None else DEFAULT_RULES:
        ops = rule.apply(ops)
    return ops


def lower(ops: List[LogicalOp]):
    """Optimized logical chain -> (stage groups, early_limit, final_limit).

    ``early_limit``: a Limit that reached the FRONT of the chain — the
    executor schedules block tasks sequentially and stops once that many
    output rows exist. A Limit elsewhere lowers to a per-block head()
    (safe over-approximation: a row beyond k within one block can never
    be among the global first k) and ``final_limit`` tells the executor
    to apply the exact global trim at the end.
    """
    groups: List[List[LogicalOp]] = []
    early_limit: Optional[int] = None
    final_limit: Optional[int] = None
    for i, op in enumerate(ops):
        if op.name == "Limit":
            k = int(op.kwargs["limit"])
            final_limit = k if final_limit is None else min(final_limit, k)
            if all(o.name == "Limit" for o in ops[:i]):
                early_limit = k if early_limit is None \
                    else min(early_limit, k)
                continue
            op = LogicalOp("LimitLocal", "block",
                           (lambda kk: lambda rows: rows[:kk])(k),
                           {"limit": k})
        if op.kind == "actor_batch":
            # Actor-pool stage (compute="actors"): a fusion BARRIER — it
            # runs on a stateful actor pool, never inside a block task
            # (reference: _internal/compute.py ActorPoolStrategy).
            groups.append([op])
            groups.append([])   # ops after it fuse into a fresh group
        elif op.kind in FUSABLE:
            if groups:
                groups[-1].append(op)
            else:
                groups.append([op])
        else:
            raise ValueError(f"cannot lower op kind {op.kind!r}")
    return [g for g in groups if g], early_limit, final_limit


def explain(ops: List[LogicalOp]) -> str:
    """Human-readable logical -> optimized -> physical rendering."""
    raw = " -> ".join(op.describe() for op in ops) or "(scan)"
    opt = optimize(ops)
    opt_s = " -> ".join(op.describe() for op in opt) or "(scan)"
    groups, early_limit, final_limit = lower(opt)
    phys = []
    if early_limit is not None:
        phys.append(f"EarlyStop[{early_limit}]")
    for g in groups:
        if g[0].kind == "actor_batch":
            comp = g[0].kwargs.get("compute")
            phys.append(f"ActorPool({g[0].describe()}, "
                        f"min={getattr(comp, 'min_size', 1)}, "
                        f"max={getattr(comp, 'max_size', None)})")
        else:
            phys.append("FusedTaskPerBlock(" +
                        "+".join(op.describe() for op in g) + ")")
    if final_limit is not None and early_limit is None:
        phys.append(f"GlobalTrim[{final_limit}]")
    return (f"Logical:   {raw}\n"
            f"Optimized: {opt_s}\n"
            f"Physical:  {' -> '.join(phys) or '(scan)'}")
