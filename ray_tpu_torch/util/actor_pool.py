"""ActorPool (reference: python/ray/util/actor_pool.py)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

from ray_tpu_torch._private import worker as worker_mod


class ActorPool:
    """Round-robins work over a fixed set of actors."""

    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._actor_by_ref = {}
        self._ref_by_submit_seq = {}
        self._submit_seq = 0
        self._drain_seq = 0

    def submit(self, fn: Callable, value: Any) -> None:
        if not self._idle:
            raise ValueError("no idle actors; call get_next first")
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._actor_by_ref[ref] = actor
        self._ref_by_submit_seq[self._submit_seq] = ref
        self._submit_seq += 1

    def has_next(self) -> bool:
        return self._drain_seq < self._submit_seq

    def get_next(self, timeout=None) -> Any:
        if not self.has_next():
            raise StopIteration("no pending results")
        ref = self._ref_by_submit_seq.pop(self._drain_seq)
        self._drain_seq += 1
        core = worker_mod.require_worker()
        value = core.get([ref], timeout=timeout)[0]
        self._idle.append(self._actor_by_ref.pop(ref))
        return value

    def get_next_unordered(self, timeout=None) -> Any:
        if not self.has_next():
            raise StopIteration("no pending results")
        core = worker_mod.require_worker()
        refs = list(self._actor_by_ref.keys())
        ready, _ = core.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, fut in list(self._ref_by_submit_seq.items()):
            if fut == ref:
                del self._ref_by_submit_seq[idx]
                if idx == self._drain_seq:
                    while self._drain_seq not in \
                            self._ref_by_submit_seq and \
                            self._drain_seq < self._submit_seq:
                        self._drain_seq += 1
                break
        value = core.get([ref])[0]
        self._idle.append(self._actor_by_ref.pop(ref))
        return value

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            if self._idle:
                self.submit(fn, v)
            else:
                yield self.get_next()
                self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            if self._idle:
                self.submit(fn, v)
            else:
                yield self.get_next_unordered()
                self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._idle.append(actor)
