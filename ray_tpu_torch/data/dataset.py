"""Dataset: lazy, block-based distributed data (port of
``ray_tpu/data/dataset.py``; reference: ``data/dataset.py:166``; plan
``_internal/plan.py:80``; bulk executor
``_internal/execution/bulk_executor.py:20``).

A dataset is input block refs + a chain of stages. Row/batch stages fuse
into ONE task per block at execution (the reference's stage fusion,
``_internal/plan.py`` _optimize); all-to-all stages (repartition, shuffle,
sort) are barriers that reshuffle materialized blocks. Results are cached
object refs, so re-iteration is free.

Blocks and batches are numpy, as in the reference: a training rank moves
its batch to its device itself. Functions travel to the workers through
the runtime's pickler (``_private/pickler.py``), never cloudpickle.
"""

from __future__ import annotations

import builtins
import glob as glob_mod
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import pickler

# ---------------------------------------------------------------- blocks
# A block is a list of rows. A row is either a dict (tabular) or any
# object (simple). Batches are dicts of numpy arrays ({"item": ...} for
# simple rows, like the reference's strict mode).


def _rows_to_batch(rows: List[Any], batch_format: str):
    if batch_format == "rows":
        return rows
    if rows and isinstance(rows[0], dict):
        cols = {k: [r[k] for r in rows] for k in rows[0]}
        if batch_format == "numpy":
            return {k: np.asarray(v) for k, v in cols.items()}
        if batch_format == "pandas":
            import pandas as pd
            return pd.DataFrame(cols)
        if batch_format == "pyarrow":
            import pyarrow as pa
            return pa.table(cols)
    else:
        if batch_format == "numpy":
            return {"item": np.asarray(rows)}
        if batch_format == "pandas":
            import pandas as pd
            return pd.DataFrame({"item": rows})
        if batch_format == "pyarrow":
            import pyarrow as pa
            return pa.table({"item": rows})
    raise ValueError(f"unknown batch_format {batch_format!r}")


def _batch_to_rows(batch) -> List[Any]:
    if isinstance(batch, list):
        return batch
    if isinstance(batch, dict):
        arrs = {k: np.asarray(v) for k, v in batch.items()}
        n = len(next(iter(arrs.values()))) if arrs else 0
        if set(arrs) == {"item"}:
            return list(arrs["item"])
        return [{k: v[i] for k, v in arrs.items()}
                for i in builtins.range(n)]
    try:  # pandas / arrow
        import pandas as pd
        if isinstance(batch, pd.DataFrame):
            return batch.to_dict("records")
    except ImportError:
        pass
    try:
        import pyarrow as pa
        if isinstance(batch, pa.Table):
            return batch.to_pylist()
    except ImportError:
        pass
    raise TypeError(f"cannot convert batch of type {type(batch)}")


# ---------------------------------------------------------------- stages


class _Stage:
    """One logical op. kind: row | batch | block (fusable per-block)."""

    def __init__(self, kind: str, fn: Callable, **kwargs):
        self.kind = kind
        self.fn = fn
        self.kwargs = kwargs

    def apply(self, rows: List[Any]) -> List[Any]:
        if self.kind == "row":
            return [y for r in rows for y in self.fn(r)]
        if self.kind == "batch":
            fmt = self.kwargs.get("batch_format", "numpy")
            size = self.kwargs.get("batch_size")
            out: List[Any] = []
            for chunk in _chunks(rows, size or len(rows) or 1):
                res = self.fn(_rows_to_batch(chunk, fmt))
                out.extend(_batch_to_rows(res))
            return out
        if self.kind == "block":
            return self.fn(rows)
        raise ValueError(self.kind)


def _chunks(seq, n):
    for i in builtins.range(0, len(seq), n):
        yield seq[i:i + n]


def _apply_stages(rows: List[Any], stages: List[_Stage]) -> List[Any]:
    for st in stages:
        rows = st.apply(rows)
    return rows


@ray_tpu_torch.remote
class _MapBatchesActor:
    """Pool worker for ``map_batches(compute=ActorPoolStrategy(...))``:
    the UDF (a class) is constructed ONCE here — model loading, GPU
    warmup — and then maps every block routed to this actor (reference:
    data/_internal/compute.py ActorPoolStrategy + _BlockWorker)."""

    def __init__(self, fn, ctor_args, ctor_kwargs):
        if isinstance(fn, type):
            self._fn = fn(*(ctor_args or ()), **(ctor_kwargs or {}))
        else:
            self._fn = fn

    def run_block(self, rows, batch_size, batch_format):
        return _Stage("batch", self._fn, batch_size=batch_size,
                      batch_format=batch_format).apply(rows)


# --------------------------------------------------------------- dataset


class ActorPoolStrategy:
    """Compute strategy for ``map_batches``: run the UDF on a pool of
    long-lived actors instead of one task per block (reference:
    ``python/ray/data/_internal/compute.py`` ActorPoolStrategy). The
    pattern exists for stateful / expensive-init UDFs — load a model
    once per actor, stream blocks through it (GPU batch inference).

    The pool starts at ``min_size`` actors and autoscales up to
    ``max_size`` while blocks are backlogged (every actor at its
    in-flight cap)."""

    def __init__(self, min_size: int = 1, max_size: Optional[int] = None):
        if min_size < 1:
            raise ValueError("min_size must be >= 1")
        if max_size is not None and max_size < min_size:
            raise ValueError("max_size must be >= min_size")
        self.min_size = int(min_size)
        self.max_size = int(max_size) if max_size is not None else None

    def __repr__(self):
        return f"ActorPoolStrategy(min={self.min_size}, max={self.max_size})"


class DataContext:
    """Execution knobs (reference: ``python/ray/data/context.py``
    DataContext.target_max_block_size — here row-count based).

    ``target_max_rows_per_block``: when set, block tasks run as dynamic
    generator tasks (``num_returns="dynamic"``) and split oversized
    outputs into multiple blocks of at most this many rows — the block
    count becomes data-dependent, which is exactly what dynamic returns
    exist for (reference: task manager dynamic returns feeding Data
    block splitting).
    """

    _instance: Optional["DataContext"] = None

    def __init__(self):
        self.target_max_rows_per_block: Optional[int] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


def _split_rows(rows: List[Any], max_rows: int):
    for i in builtins.range(0, len(rows), max_rows):
        yield rows[i:i + max_rows]


class _ShuffleMerger:
    """Reduce-side actor of the push-based shuffle: accumulates its
    partition's parts AS MAP TASKS FINISH (peak memory = one output
    partition, not the dataset), then emits one block. Parts carry their
    source-block index so the merged output preserves global row order
    regardless of map-task completion order."""

    def __init__(self, finish_blob):
        self._parts: List[Any] = []   # (source_index, rows)
        self._finish = (pickler.loads(finish_blob)
                        if finish_blob else None)

    def add(self, order_key: int, part) -> bool:
        self._parts.append((order_key, part))
        return True

    def finish(self):
        self._parts.sort(key=lambda kv: kv[0])
        rows = [r for _k, part in self._parts for r in part]
        self._parts = []
        return self._finish(rows) if self._finish else rows


def _push_based_shuffle(block_refs: List[Any], partition_fn,
                        num_partitions: int,
                        merge_finish=None) -> List[Any]:
    """Two pipelined stages (reference:
    ``python/ray/data/_internal/push_based_shuffle.py``): map tasks split
    each block into ``num_partitions`` parts; parts stream to per-
    partition merger actors the moment their map task completes (the
    "push"), overlapping map and merge with bounded merger memory. The
    driver only routes object refs — row data never passes through it.
    """
    P = num_partitions
    finish_blob = pickler.dumps(merge_finish) if merge_finish else None
    merger_cls = ray_tpu_torch.remote(_ShuffleMerger)
    mergers = [merger_cls.remote(finish_blob)
               for _ in builtins.range(P)]

    @ray_tpu_torch.remote
    def map_block(rows, idx):
        parts = partition_fn(rows, idx)
        return tuple(parts) if P > 1 else parts[0]

    pending: Dict[Any, tuple] = {}
    for i, b in enumerate(block_refs):
        refs = map_block.options(num_returns=P).remote(b, i)
        refs = refs if isinstance(refs, list) else [refs]
        pending[refs[0]] = (i, refs)
    adds = []
    outstanding = list(pending.keys())
    while outstanding:
        ready, outstanding = ray_tpu_torch.wait(outstanding, num_returns=1)
        idx, refs = pending.pop(ready[0])
        for p, r in enumerate(refs):
            adds.append(mergers[p].add.remote(idx, r))
    ray_tpu_torch.get(adds)           # every part merged
    out = [m.finish.remote() for m in mergers]
    ray_tpu_torch.wait(out, num_returns=P)   # blocks exist before mergers die
    for m in mergers:
        try:
            ray_tpu_torch.kill(m)
        except Exception:
            pass
    return out


def _resolve_dynamic_blocks(gen_refs: List[Any]) -> List[Any]:
    """Flatten generator refs into per-block refs (one small get per
    generator object; the blocks themselves stay in the store)."""
    out: List[Any] = []
    for gen in ray_tpu_torch.get(gen_refs):
        out.extend(gen)
    return out


class Dataset:
    def __init__(self, block_refs: List[Any],
                 stages: Optional[List[_Stage]] = None,
                 logical: Optional[list] = None):
        self._input_blocks = list(block_refs)
        self._stages: List[_Stage] = list(stages or [])
        # Logical operator chain mirroring the stages (reference:
        # _internal/logical/ — what explain() and the optimizer rules
        # operate on; see ray_tpu_torch/data/logical.py).
        self._logical: list = list(logical or [])
        self._cached: Optional[List[Any]] = None  # executed block refs

    # -------------------------------------------------------- construction

    def _with_stage(self, stage: _Stage, lop) -> "Dataset":
        # Every stage carries its NAMED logical op: rules like limit
        # pushdown key on names, so an unnamed stage would be unsound.
        return Dataset(self._input_blocks, self._stages + [stage],
                       self._logical + [lop])

    def explain(self) -> str:
        """Render logical -> optimized -> physical plans (reference:
        Dataset plan introspection over _internal/logical/)."""
        from ray_tpu_torch.data import logical as logical_mod

        text = logical_mod.explain(self._logical)
        print(text)
        return text

    # ------------------------------------------------------------ executor

    def _lowered_segments(self):
        """(segments, early_limit, final_limit) from the optimized
        logical plan. Each segment is ("tasks", [stage...]) — one fused
        task per block — or ("actors", stage) — an actor-pool
        map_batches stage (fusion barrier)."""
        from ray_tpu_torch.data import logical as logical_mod

        if not self._logical:
            segs = [("tasks", self._stages)] if self._stages else []
            return segs, None, None
        opt = logical_mod.optimize(self._logical)
        groups, early_limit, final_limit = logical_mod.lower(opt)
        segments = []
        for g in groups:
            if g[0].kind == "actor_batch":
                op = g[0]
                segments.append(("actors", _Stage(
                    "actor_batch", op.fn, **op.kwargs)))
            else:
                segments.append(("tasks", [
                    _Stage(op.kind, op.fn,
                           **{k: v for k, v in op.kwargs.items()
                              if k in ("batch_size", "batch_format")})
                    for op in g]))
        return segments, early_limit, final_limit

    def _has_actor_compute(self) -> bool:
        return any(getattr(op, "kind", None) == "actor_batch"
                   for op in self._logical)

    def _lowered(self):
        """(flat stages, early_limit, final_limit) for the task-only
        executors. Callers must route actor-compute plans through
        _execute_segments first (_has_actor_compute)."""
        segments, early_limit, final_limit = self._lowered_segments()
        stages: List[_Stage] = []
        for tag, payload in segments:
            assert tag == "tasks", \
                "actor-compute plan reached a task-only executor"
            stages.extend(payload)
        return stages, early_limit, final_limit

    def _execute(self) -> List[Any]:
        """Optimize the logical plan, lower to fused stages, execute one
        task per block (bulk executor); a pushed-down Limit stops
        scheduling block tasks once enough rows exist."""
        if self._cached is not None:
            return self._cached
        if self._has_actor_compute():
            self._cached = self._execute_segments()
            return self._cached
        stages, early_limit, final_limit = self._lowered()
        if early_limit is not None:
            self._cached = self._execute_with_limit(stages, early_limit)
            return self._cached
        if final_limit is not None:
            refs = self._run_all(stages)
            self._cached = self._trim_blocks(refs, final_limit)
            return self._cached
        if not stages:
            self._cached = self._input_blocks
            return self._cached
        max_rows = DataContext.get_current().target_max_rows_per_block

        if max_rows:
            # Dynamic-generator execution: a block task yields as many
            # output blocks as its data needs (block-size targeting).
            @ray_tpu_torch.remote(num_returns="dynamic")
            def _run_block_dyn(rows):
                out = _apply_stages(rows, stages)
                if not out:
                    yield out
                else:
                    yield from _split_rows(out, max_rows)

            self._cached = _resolve_dynamic_blocks(
                [_run_block_dyn.remote(b) for b in self._input_blocks])
            return self._cached

        self._cached = self._run_all(stages)
        return self._cached

    def _execute_segments(self) -> List[Any]:
        """Executor for plans with actor-pool stages: task segments run
        one fused task per block; actor segments stream blocks through a
        stateful pool (reference: _internal/compute.py — the planner
        chooses TaskPoolStrategy or ActorPoolStrategy per op)."""
        segments, early_limit, final_limit = self._lowered_segments()
        blocks = list(self._input_blocks)
        if early_limit is not None:
            # Front-of-chain limit caps what the chain CONSUMES.
            blocks = self._trim_blocks(blocks, early_limit)
        for tag, payload in segments:
            if tag == "actors":
                blocks = list(self._actor_pool_map(blocks, payload))
            elif payload:
                blocks = Dataset(blocks)._run_all(payload)
        if final_limit is not None and early_limit is None:
            blocks = self._trim_blocks(blocks, final_limit)
        return blocks

    @staticmethod
    def _actor_pool_map(block_refs: List[Any], stage: _Stage,
                        inflight_per_actor: int = 2) -> Iterator[Any]:
        """Map blocks through an autoscaling actor pool, preserving
        block order. Yields each block's result ref as its dispatch is
        admitted (bounded in-flight = streaming backpressure). The pool
        grows one actor at a time while every actor is at its in-flight
        cap and blocks are waiting, up to the strategy's max_size."""
        comp = stage.kwargs.get("compute") or ActorPoolStrategy()
        max_size = comp.max_size or max(comp.min_size, 4)
        ctor = (stage.fn, stage.kwargs.get("fn_constructor_args") or (),
                stage.kwargs.get("fn_constructor_kwargs") or {})
        bs = stage.kwargs.get("batch_size")
        bf = stage.kwargs.get("batch_format", "numpy")
        actors = [_MapBatchesActor.remote(*ctor)
                  for _ in builtins.range(comp.min_size)]
        pending: Dict[Any, int] = {}   # result ref -> actor index
        results: List[Any] = []
        try:
            for b in block_refs:
                while True:
                    loads = [0] * len(actors)
                    for idx in pending.values():
                        loads[idx] += 1
                    idx = min(builtins.range(len(actors)),
                              key=lambda i: loads[i])
                    if loads[idx] < inflight_per_actor:
                        break
                    if len(actors) < max_size:
                        # Backlogged: grow the pool within bounds.
                        actors.append(_MapBatchesActor.remote(*ctor))
                        idx = len(actors) - 1
                        break
                    # At capacity: wait for one completion.
                    ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
                    for r in ready:
                        pending.pop(r, None)
                ref = actors[idx].run_block.remote(b, bs, bf)
                pending[ref] = idx
                results.append(ref)
            # Results live in the node object store, so the pool can be
            # torn down once every block has been produced.
            if results:
                ray_tpu_torch.wait(results, num_returns=len(results),
                             timeout=None)
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
        return results

    def _run_all(self, stages: List[_Stage]) -> List[Any]:
        if not stages:
            return list(self._input_blocks)

        @ray_tpu_torch.remote
        def _run_block(rows):
            return _apply_stages(rows, stages)

        return [_run_block.remote(b) for b in self._input_blocks]

    def _trim_blocks(self, refs: List[Any], limit: int) -> List[Any]:
        """Exact global limit over executed blocks (post non-front-limit
        lowering: blocks were already capped per-block)."""
        @ray_tpu_torch.remote
        def _count(rows):
            return len(rows)

        @ray_tpu_torch.remote
        def _head(rows, k):
            return rows[:k]

        counts = ray_tpu_torch.get([_count.remote(r) for r in refs])
        out: List[Any] = []
        produced = 0
        for ref, n in zip(refs, counts):
            if produced >= limit:
                break
            if produced + n > limit:
                ref = _head.remote(ref, limit - produced)
                n = limit - produced
            out.append(ref)
            produced += n
        return out

    def _execute_with_limit(self, stages: List[_Stage],
                            limit: int) -> List[Any]:
        """Early-stop execution for a FRONT-of-chain Limit: cap the
        INPUT rows the rest of the chain consumes (a leading limit
        bounds consumption, whatever filter/flat_map follow), stopping
        block scheduling once enough input exists. Unscheduled blocks
        are never read — the win limit pushdown exists for."""
        @ray_tpu_torch.remote
        def _count(rows):
            return len(rows)

        @ray_tpu_torch.remote
        def _run_block(rows, take):
            rows = rows[:take] if take is not None else rows
            return _apply_stages(rows, stages) if stages else rows

        counts = ray_tpu_torch.get([_count.remote(b)
                              for b in self._input_blocks])
        out: List[Any] = []
        consumed = 0
        for b, n_in in zip(self._input_blocks, counts):
            if consumed >= limit:
                break
            take = min(n_in, limit - consumed)
            out.append(_run_block.remote(
                b, take if take < n_in else None))
            consumed += take
        return out

    def materialize(self) -> "Dataset":
        ds = Dataset(self._execute())
        ds._cached = ds._input_blocks
        return ds

    def iter_block_results(self, prefetch_blocks: int = 2
                           ) -> Iterator[List[Any]]:
        """Streaming executor: yield each block's transformed rows in
        block order while keeping at most ``prefetch_blocks`` block tasks
        in flight ahead of the consumer — execution overlaps consumption
        with bounded memory (reference:
        _internal/execution/streaming_executor.py:35 + backpressure via
        resource_manager; the bound here is the in-flight block count).
        Already-materialized datasets stream from the cache."""
        import collections as _collections

        prefetch = max(1, int(prefetch_blocks))
        if self._has_actor_compute():
            # Actor-pool plans: the pool itself streams with bounded
            # in-flight (see _actor_pool_map); iterate its output blocks
            # (_execute serves from the cache when already materialized —
            # _lowered() below is task-only and would assert).
            for ref in self._execute():
                yield ray_tpu_torch.get(ref)
            return
        stages, early_limit, final_limit = self._lowered()
        if early_limit is not None or final_limit is not None:
            # Limits need the sequential early-stop/trim executor; its
            # output blocks then stream.
            for ref in self._execute():
                yield ray_tpu_torch.get(ref)
            return
        if self._cached is not None or not stages:
            for ref in (self._cached if self._cached is not None
                        else self._input_blocks):
                yield ray_tpu_torch.get(ref)
            return

        @ray_tpu_torch.remote
        def _run_block(rows):
            return _apply_stages(rows, stages)

        blocks = iter(self._input_blocks)
        in_flight: _collections.deque = _collections.deque()
        for b in itertools.islice(blocks, prefetch + 1):
            in_flight.append(_run_block.remote(b))
        while in_flight:
            ref = in_flight.popleft()
            nxt = next(blocks, None)
            if nxt is not None:
                in_flight.append(_run_block.remote(nxt))
            yield ray_tpu_torch.get(ref)

    def _has_limit(self) -> bool:
        return any(getattr(op, "name", None) == "Limit"
                   for op in self._logical)

    def streaming_split(self, n: int) -> List["Dataset"]:
        """Split by round-robin over INPUT blocks without executing
        anything: each shard keeps the stage chain lazy, so data-parallel
        consumers stream their own blocks (reference:
        dataset.streaming_split). Use split() for row-exact splitting.

        A Limit in the plan is GLOBAL (reference semantics): the limited
        dataset executes first and its output blocks are what get
        sharded — propagating the Limit per shard would return up to n*k
        rows."""
        if self._has_limit():
            return Dataset(self._execute()).streaming_split(n)
        shards = []
        for i in builtins.range(n):
            shards.append(Dataset(self._input_blocks[i::n], self._stages,
                                  self._logical))
        return shards

    def _all_rows(self) -> List[Any]:
        out: List[Any] = []
        for rows in ray_tpu_torch.get(self._execute()):
            out.extend(rows)
        return out

    # ---------------------------------------------------------- transforms

    def _named(self, name: str, stage: _Stage, **meta) -> "Dataset":
        from ray_tpu_torch.data.logical import LogicalOp

        return self._with_stage(
            stage, LogicalOp(name, stage.kind, stage.fn,
                             {**stage.kwargs, **meta}))

    def map(self, fn: Callable) -> "Dataset":
        return self._named("Map", _Stage("row", lambda r, f=fn: [f(r)]))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._named("FlatMap", _Stage("row", fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._named("Filter", _Stage(
            "row", lambda r, f=fn: [r] if f(r) else []))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    compute: Optional[Any] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None
                    ) -> "Dataset":
        """Map over batches. With ``compute="actors"`` (or an
        ``ActorPoolStrategy``), ``fn`` may be a CLASS: one instance is
        constructed per pool actor (expensive init — e.g. loading a model
        onto a GPU — runs once per actor, not once per block) and
        its ``__call__`` maps each batch (reference:
        data/_internal/compute.py ActorPoolStrategy)."""
        if compute is None:
            return self._named("MapBatches", _Stage(
                "batch", fn, batch_size=batch_size,
                batch_format=batch_format))
        if compute == "actors":
            compute = ActorPoolStrategy()
        if not isinstance(compute, ActorPoolStrategy):
            raise ValueError(
                f"compute must be None, 'actors', or an ActorPoolStrategy; "
                f"got {compute!r}")
        return self._named("MapBatches", _Stage(
            "actor_batch", fn, batch_size=batch_size,
            batch_format=batch_format, compute=compute,
            fn_constructor_args=tuple(fn_constructor_args),
            fn_constructor_kwargs=dict(fn_constructor_kwargs or {})))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(row):
            row = dict(row)
            row[name] = fn(row)
            return [row]
        return self._named("AddColumn", _Stage("row", add))

    def drop_columns(self, cols: Sequence[str]) -> "Dataset":
        colset = set(cols)
        return self._named("DropColumns", _Stage(
            "row", lambda r: [{k: v for k, v in r.items()
                               if k not in colset}]), cols=list(cols))

    def select_columns(self, cols: Sequence[str]) -> "Dataset":
        cols = list(cols)
        return self._named("SelectColumns", _Stage(
            "row", lambda r: [{k: r[k] for k in cols}]), cols=cols)

    def limit(self, k: int) -> "Dataset":
        """Logical Limit: pushed toward the source past row-preserving
        operators so execution stops scheduling block tasks early
        (reference: rules/limit_pushdown.py)."""
        from ray_tpu_torch.data.logical import LogicalOp

        return Dataset(self._input_blocks, self._stages,
                       self._logical + [LogicalOp(
                           "Limit", "limit", None, {"limit": int(k)})])

    # ---------------------------------------------------------- all-to-all

    def repartition(self, num_blocks: int) -> "Dataset":
        """Push-based shuffle into ``num_blocks`` even partitions,
        preserving global row order (a count pass computes each block's
        offset; rows map to contiguous target ranges)."""
        n = max(1, num_blocks)
        blocks = self._execute()

        @ray_tpu_torch.remote
        def count(rows):
            return len(rows)

        counts = ray_tpu_torch.get([count.remote(b) for b in blocks])
        offsets = list(itertools.accumulate([0] + counts))
        total = offsets[-1]
        per = (total + n - 1) // n if total else 1

        def partition(rows, idx):
            start = offsets[idx]
            parts = [[] for _ in builtins.range(n)]
            for i, r in enumerate(rows):
                parts[min((start + i) // per, n - 1)].append(r)
            return parts

        return Dataset(_push_based_shuffle(blocks, partition, n))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Distributed random shuffle: rows scatter to random partitions
        (map side), each merger permutes its partition locally — no
        driver materialization."""
        nb = max(1, len(self._input_blocks))
        base_seed = seed if seed is not None else 0x5eed

        def partition(rows, idx):
            # Seeded per source block: deterministic for a given seed
            # across runs and processes (no str-hash salting).
            rng = np.random.default_rng((base_seed, idx))
            parts = [[] for _ in builtins.range(nb)]
            for r in rows:
                parts[int(rng.integers(0, nb))].append(r)
            return parts

        def finish(rows):
            rng = np.random.default_rng(base_seed + 1)
            order = rng.permutation(len(rows))
            return [rows[i] for i in order]

        return Dataset(_push_based_shuffle(self._execute(), partition, nb,
                                           merge_finish=finish))

    def sort(self, key: Optional[Any] = None,
             descending: bool = False) -> "Dataset":
        """Distributed sample-based range sort (reference:
        data/_internal/push_based_shuffle.py + sort.py sample stage):
        sample keys -> choose P-1 range boundaries -> range-partition on
        the map side -> each merger sorts locally -> globally ordered
        block sequence, without the driver ever holding the dataset."""
        import bisect

        if isinstance(key, str):
            keyfn = lambda r: r[key]  # noqa: E731
        elif key is None:
            keyfn = lambda r: r       # noqa: E731
        else:
            keyfn = key
        blocks = self._execute()
        nb = max(1, len(blocks))

        @ray_tpu_torch.remote
        def sample_keys(rows):
            step = max(1, len(rows) // 20)
            return sorted(keyfn(r) for r in rows[::step])

        samples = sorted(
            k for part in ray_tpu_torch.get([sample_keys.remote(b)
                                       for b in blocks]) for k in part)
        if samples and nb > 1:
            bounds = [samples[int(len(samples) * i / nb)]
                      for i in builtins.range(1, nb)]
        else:
            bounds = []

        def partition(rows, idx):
            parts = [[] for _ in builtins.range(nb)]
            for r in rows:
                parts[bisect.bisect_right(bounds, keyfn(r))].append(r)
            return parts

        def finish(rows):
            rows.sort(key=keyfn)
            return rows

        out = _push_based_shuffle(blocks, partition, nb,
                                  merge_finish=finish)
        if descending:
            out = list(reversed(out))

            @ray_tpu_torch.remote
            def rev(rows):
                return list(reversed(rows))

            out = [rev.remote(b) for b in out]
        return Dataset(out)

    def zip(self, other: "Dataset") -> "Dataset":
        a, b = self._all_rows(), other._all_rows()
        if len(a) != len(b):
            raise ValueError(f"zip length mismatch: {len(a)} vs {len(b)}")
        def merge(x, y):
            if isinstance(x, dict) and isinstance(y, dict):
                out = dict(x)
                for k, v in y.items():
                    out[k + "_1" if k in out else k] = v
                return out
            return (x, y)
        return Dataset([ray_tpu_torch.put([merge(x, y) for x, y in
                                     builtins.zip(a, b)])])

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._execute())
        for o in others:
            refs.extend(o._execute())
        return Dataset(refs)

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into n datasets (for n data-parallel consumers; reference:
        ``dataset.py`` split / streaming_split)."""
        rows = self._all_rows()
        if equal:
            per = len(rows) // n
            parts = [rows[i * per:(i + 1) * per] for i in builtins.range(n)]
        else:
            per = (len(rows) + n - 1) // n
            parts = [rows[i * per:(i + 1) * per] for i in builtins.range(n)]
        return [Dataset([ray_tpu_torch.put(p)]) for p in parts]

    def groupby(self, key: str) -> "GroupedDataset":
        return GroupedDataset(self, key)

    # ----------------------------------------------------------- pipelines

    def window(self, *, blocks_per_window: int = 2) -> "DatasetPipeline":
        """Split into a pipeline of windows of input blocks; each window
        executes only when iteration reaches it (reference:
        dataset.window -> DatasetPipeline, _internal pipeline executor).

        A Limit in the plan is applied globally first (see
        streaming_split) — windows of an already-limited dataset."""
        if self._has_limit():
            return Dataset(self._execute()).window(
                blocks_per_window=blocks_per_window)
        blocks, stages = self._input_blocks, self._stages
        logical = self._logical

        def windows():
            for i in builtins.range(0, len(blocks), blocks_per_window):
                yield Dataset(blocks[i:i + blocks_per_window], stages,
                              logical)

        return DatasetPipeline(windows, length=max(
            1, (len(blocks) + blocks_per_window - 1) // blocks_per_window))

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        """Epoch pipeline: the dataset repeats ``times`` times (forever
        when None) — feed ``iter_batches`` straight into a training loop
        (reference: dataset.repeat)."""
        ds = self

        def epochs():
            i = 0
            while times is None or i < times:
                yield ds
                i += 1

        return DatasetPipeline(epochs, length=times)

    # --------------------------------------------------------- consumption

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for ref in self._execute():
            out.extend(ray_tpu_torch.get(ref))
            if len(out) >= limit:
                return out[:limit]
        return out

    def take_all(self) -> List[Any]:
        return self._all_rows()

    def count(self) -> int:
        @ray_tpu_torch.remote
        def _count(rows):
            return len(rows)
        return sum(ray_tpu_torch.get([_count.remote(b) for b in self._execute()]))

    def sum(self, on: Optional[str] = None):
        rows = self._all_rows()
        vals = [r[on] for r in rows] if on else rows
        return sum(vals)

    def min(self, on: Optional[str] = None):
        rows = self._all_rows()
        return min((r[on] for r in rows) if on else rows)

    def max(self, on: Optional[str] = None):
        rows = self._all_rows()
        return max((r[on] for r in rows) if on else rows)

    def mean(self, on: Optional[str] = None):
        rows = self._all_rows()
        vals = [r[on] for r in rows] if on else rows
        return sum(vals) / len(vals)

    def schema(self) -> Optional[Dict[str, str]]:
        rows = self.take(1)
        if not rows:
            return None
        r = rows[0]
        if isinstance(r, dict):
            return {k: type(v).__name__ for k, v in r.items()}
        return {"item": type(r).__name__}

    def num_blocks(self) -> int:
        return len(self._input_blocks)

    def iter_rows(self) -> Iterator[Any]:
        for rows in self.iter_block_results():
            yield from rows

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_blocks: int = 2) -> Iterator[Any]:
        """Stream batches: blocks execute ahead of the consumer through
        the streaming executor (bounded in-flight), so training overlaps
        with ingest instead of waiting for the whole dataset."""
        buf: List[Any] = []
        for rows in self.iter_block_results(prefetch_blocks=prefetch_blocks):
            buf.extend(rows)
            while len(buf) >= batch_size:
                yield _rows_to_batch(buf[:batch_size], batch_format)
                buf = buf[batch_size:]
        if buf and not drop_last:
            yield _rows_to_batch(buf, batch_format)

    def show(self, limit: int = 20):
        for r in self.take(limit):
            print(r)

    def to_pandas(self):
        return _rows_to_batch(self._all_rows(), "pandas")

    # -------------------------------------------------------------- output

    def write_json(self, path: str):
        import json
        import os
        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            with open(os.path.join(path, f"part-{i:05d}.json"), "w") as f:
                for row in ray_tpu_torch.get(ref):
                    f.write(json.dumps(_jsonable(row)) + "\n")

    def write_parquet(self, path: str):
        import os
        import pyarrow as pa
        import pyarrow.parquet as pq
        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            rows = ray_tpu_torch.get(ref)
            if not rows:
                continue
            pq.write_table(_rows_to_batch(rows, "pyarrow"),
                           os.path.join(path, f"part-{i:05d}.parquet"))

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._input_blocks)}, "
                f"stages={len(self._stages)})")


def _jsonable(row):
    if isinstance(row, dict):
        return {k: _jsonable(v) for k, v in row.items()}
    if isinstance(row, np.generic):
        return row.item()
    if isinstance(row, np.ndarray):
        return row.tolist()
    return row


class DatasetPipeline:
    """A sequence of Datasets (windows or epochs) executed lazily, one
    window ahead of the consumer (reference: DatasetPipeline,
    data/dataset_pipeline.py). Transformations apply per-window."""

    def __init__(self, windows_factory: Callable[[], Iterator["Dataset"]],
                 length: Optional[int] = None):
        self._factory = windows_factory
        self.length = length

    def _map_windows(self, f: Callable[["Dataset"], "Dataset"]
                     ) -> "DatasetPipeline":
        factory = self._factory

        def windows():
            for w in factory():
                yield f(w)

        return DatasetPipeline(windows, length=self.length)

    def map(self, fn):
        return self._map_windows(lambda d: d.map(fn))

    def flat_map(self, fn):
        return self._map_windows(lambda d: d.flat_map(fn))

    def filter(self, fn):
        return self._map_windows(lambda d: d.filter(fn))

    def map_batches(self, fn, **kw):
        return self._map_windows(lambda d: d.map_batches(fn, **kw))

    def random_shuffle_each_window(self, *, seed=None):
        return self._map_windows(
            lambda d: d.random_shuffle(seed=seed))

    def iter_windows(self) -> Iterator["Dataset"]:
        return self._factory()

    def iter_rows(self) -> Iterator[Any]:
        for w in self._factory():
            yield from w.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for w in self._factory():
            yield from w.iter_batches(**kw)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for r in self.iter_rows():
            out.append(r)
            if len(out) >= limit:
                break
        return out

    def __repr__(self):
        n = "inf" if self.length is None else self.length
        return f"DatasetPipeline(windows={n})"


class GroupedDataset:
    """Reference: ``data/grouped_data.py`` — map-side partial aggregation
    per block, reduced on the driver."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, init, accum, finalize=None):
        key = self._key

        @ray_tpu_torch.remote
        def partial(rows):
            acc: Dict[Any, Any] = {}
            for r in rows:
                k = r[key]
                acc[k] = accum(acc.get(k, init()), r)
            return acc

        partials = ray_tpu_torch.get(
            [partial.remote(b) for b in self._ds._execute()])
        merged: Dict[Any, Any] = {}
        for p in partials:
            for k, v in p.items():
                merged[k] = _merge_acc(merged.get(k), v)
        out = []
        for k in sorted(merged, key=repr):
            v = merged[k]
            out.append({self._key: k,
                        **(finalize(v) if finalize else v)})
        return Dataset([ray_tpu_torch.put(out)])

    def count(self) -> Dataset:
        return self._agg(lambda: {"count": 0},
                         lambda a, r: {"count": a["count"] + 1})

    def sum(self, on: str) -> Dataset:
        return self._agg(lambda: {f"sum({on})": 0},
                         lambda a, r: {f"sum({on})": a[f"sum({on})"] + r[on]})

    def mean(self, on: str) -> Dataset:
        return self._agg(
            lambda: {"_s": 0.0, "_n": 0},
            lambda a, r: {"_s": a["_s"] + r[on], "_n": a["_n"] + 1},
            finalize=lambda a: {f"mean({on})": a["_s"] / a["_n"]})


def _merge_acc(a, b):
    if a is None:
        return b
    out = {}
    for k in b:
        out[k] = a.get(k, 0) + b[k]
    return out


# ------------------------------------------------------------ construction


def _make_blocks(rows: List[Any], parallelism: int) -> List[Any]:
    n = max(1, min(parallelism, len(rows)) if rows else 1)
    per = (len(rows) + n - 1) // n if rows else 1
    return [ray_tpu_torch.put(rows[i * per:(i + 1) * per])
            for i in builtins.range(n)]


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    return Dataset(_make_blocks(list(items), parallelism))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return from_items(list(builtins.range(n)), parallelism=parallelism)


def from_numpy(arr: np.ndarray, *, parallelism: int = 8) -> Dataset:
    return from_items([{"data": row} for row in arr],
                      parallelism=parallelism)


def from_pandas(df, *, parallelism: int = 8) -> Dataset:
    return from_items(df.to_dict("records"), parallelism=parallelism)


def from_arrow(table, *, parallelism: int = 8) -> Dataset:
    return from_items(table.to_pylist(), parallelism=parallelism)


def _expand_paths(paths) -> List[str]:
    import os
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    return out


def _read_files(paths, reader: Callable, parallelism: int) -> Dataset:
    files = _expand_paths(paths)
    max_rows = DataContext.get_current().target_max_rows_per_block

    if max_rows:
        # A read task emits one block per target-size chunk of its file —
        # variable counts per file, via dynamic returns.
        @ray_tpu_torch.remote(num_returns="dynamic")
        def load_dyn(fp):
            rows = reader(fp)
            if not rows:
                yield rows
            else:
                yield from _split_rows(rows, max_rows)

        return Dataset(_resolve_dynamic_blocks(
            [load_dyn.remote(fp) for fp in files]))

    @ray_tpu_torch.remote
    def load(fp):
        return reader(fp)

    refs = [load.remote(fp) for fp in files]
    return Dataset(refs)


def read_text(paths, *, parallelism: int = 8) -> Dataset:
    def rd(fp):
        with open(fp) as f:
            return [{"text": line.rstrip("\n")} for line in f]
    return _read_files(paths, rd, parallelism)


def read_binary_files(paths, *, parallelism: int = 8) -> Dataset:
    def rd(fp):
        with open(fp, "rb") as f:
            return [{"bytes": f.read(), "path": fp}]
    return _read_files(paths, rd, parallelism)


def read_csv(paths, *, parallelism: int = 8) -> Dataset:
    def rd(fp):
        import pandas as pd
        return pd.read_csv(fp).to_dict("records")
    return _read_files(paths, rd, parallelism)


def read_json(paths, *, parallelism: int = 8) -> Dataset:
    def rd(fp):
        import json
        with open(fp) as f:
            return [json.loads(line) for line in f if line.strip()]
    return _read_files(paths, rd, parallelism)


def read_parquet(paths, *, parallelism: int = 8) -> Dataset:
    def rd(fp):
        import pyarrow.parquet as pq
        return pq.read_table(fp).to_pylist()
    return _read_files(paths, rd, parallelism)
