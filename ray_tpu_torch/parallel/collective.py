"""Collective communication (port of ``ray_tpu/parallel/collective.py``).

Three backends, the reference's under the port's names:

- ``local`` (for ``xla``): one process, a list of devices, rank i ==
  device i. The ops take and return one tensor per rank. On CUDA devices
  they are ``torch.cuda.nccl`` calls; on the CPU, plain torch over the
  stacked list.
- ``torch_dist`` (for ``xla_dist``): one process per rank. The ranks meet
  through the group's named coordinator actor, rank 0 posts the address
  of a ``torch.distributed`` world on its node, and every rank joins it
  (``join_world``). The dense ops are ``torch.distributed`` calls on
  tensors on the group's device: NCCL when that device is CUDA, gloo when
  it is the CPU.
- ``store``: ranks exchange numpy values through the coordinator actor and
  reduce locally; the always-available path.

Every group that reaches a coordinator takes ``runtime``: any object with
the runtime seam's calls (``remote``, ``get``, ``get_actor``, ``kill``),
such as the ``ray_tpu`` module. Without one, the ranks of this process meet
in one shared in-process ``LocalRuntime``. The reference's timeline spans
have no counterpart: the port has no timeline.

A gang is poisoned through its coordinator (``poison_group``); each member's
watcher sees the flag within a heartbeat and a pending op raises
``GangMemberDiedError``. ``torch_dist`` cannot always unblock an op from
another thread: aborting the world ends a pending NCCL op, but a pending
gloo op whose peer is alive and absent ignores both abort and
``destroy_process_group`` and ends at the world's own timeout,
``collective_op_timeout_s``. A peer that dies closes its gloo connections,
and the survivors' ops fail within about a second.
"""

from __future__ import annotations

import collections
import datetime
import logging
import socket
import threading
import time
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private.config import config
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.exceptions import GangMemberDiedError
from ray_tpu_torch.runtime import ActorDiedError, LocalRuntime

logger = logging.getLogger("ray_tpu_torch.collective")


class ReduceOp(Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    AVG = "avg"


class Backend(str, Enum):
    LOCAL = "local"            # single process: rank == local device
    TORCH_DIST = "torch_dist"  # one process per rank, torch.distributed
    STORE = "store"


_groups: Dict[str, "BaseGroup"] = {}
_groups_lock = threading.Lock()

DEFAULT_GROUP_NAME = "default"

_local_runtime: Optional[LocalRuntime] = None


def _runtime(runtime: Any) -> Any:
    """``runtime``, or the in-process runtime every rank of this process
    that passes none shares (its coordinators must be found by name)."""
    global _local_runtime
    if runtime is not None:
        return runtime
    with _groups_lock:
        if _local_runtime is None:
            _local_runtime = LocalRuntime()
        return _local_runtime


def _runtime_errors(runtime: Any):
    """(the runtime's get-timeout error, its dead-actor error). The in-process
    runtime never times out a get and raises its own ``ActorDiedError``."""
    exc = getattr(runtime, "exceptions", None)
    return (getattr(exc, "GetTimeoutError", TimeoutError),
            getattr(exc, "RayActorError", ActorDiedError))


def _group_device(device: DeviceLike) -> torch.device:
    """``resolve_device(device)`` with a CUDA index: a world's NCCL
    communicator belongs to one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` (array or tensor) on ``device``: an op never writes
    into its caller's value."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    return torch.from_numpy(np.array(x)).to(device)


class BaseGroup:
    """Interface every collective backend implements."""

    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name

    # Each op takes/returns arrays or tensors; list-valued ops are
    # rank-major.
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        raise NotImplementedError

    def barrier(self):
        raise NotImplementedError

    def broadcast(self, tensor, src_rank: int = 0):
        raise NotImplementedError

    def allgather(self, tensor):
        raise NotImplementedError

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        raise NotImplementedError

    def send(self, tensor, dst_rank: int):
        raise NotImplementedError

    def recv(self, shape, dtype, src_rank: int):
        raise NotImplementedError

    def destroy(self):
        pass


# ------------------------------------------------------------------- local


def _reduce_stack(x: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """Reduce a rank-major stack over its first dim."""
    if op == ReduceOp.SUM:
        return x.sum(0)
    if op == ReduceOp.AVG:
        return x.mean(0) if x.is_floating_point() else x.double().mean(0)
    if op == ReduceOp.MAX:
        return x.amax(0)
    if op == ReduceOp.MIN:
        return x.amin(0)
    if op == ReduceOp.PRODUCT:
        return x.prod(0)
    raise NotImplementedError(op)


# ncclRedOp_t: ``torch.cuda.nccl`` takes the enum's values and names only
# ``SUM``. AVG is a sum divided by the world size, as on the other paths.
_NCCL_OPS = {ReduceOp.SUM: 0, ReduceOp.AVG: 0, ReduceOp.PRODUCT: 1,
             ReduceOp.MAX: 2, ReduceOp.MIN: 3}


class LocalGroup(BaseGroup):
    """In-process group over a list of devices: rank i == device i.

    Each op takes a list of ``world_size`` arrays or tensors (one per rank,
    like the reference's ``*_multigpu`` variants) and returns a list of
    tensors, rank i's on device i. On distinct CUDA devices the ops are
    ``torch.cuda.nccl`` calls; otherwise plain torch over the stacked list
    on the first device.
    """

    def __init__(self, world_size: int, rank: int, group_name: str,
                 devices: Optional[Sequence[DeviceLike]] = None):
        super().__init__(world_size, rank, group_name)
        if devices is None:
            resolve_device(None)
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [_group_device(d) for d in devices]
        if len(devs) < world_size:
            raise ValueError(
                f"local group needs {world_size} devices, have {len(devs)}")
        self.devices = devs[:world_size]
        self._nccl = (all(d.type == "cuda" for d in self.devices)
                      and len(set(self.devices)) == world_size)

    def _inputs(self, tensors: Sequence[Any]) -> List[torch.Tensor]:
        if len(tensors) != self.world_size:
            raise ValueError(
                f"need {self.world_size} tensors, got {len(tensors)}")
        return [_as_tensor(t, d).contiguous()
                for t, d in zip(tensors, self.devices)]

    def _spread(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.to(d, copy=True) for d in self.devices]

    def allreduce(self, tensors, op: ReduceOp = ReduceOp.SUM):
        xs = self._inputs(tensors)
        if self._nccl:
            from torch.cuda import nccl

            nccl.all_reduce(xs, op=_NCCL_OPS[op])
            if op == ReduceOp.AVG:
                xs = [(x if x.is_floating_point() else x.double())
                      / self.world_size for x in xs]
            return xs
        return self._spread(_reduce_stack(torch.stack(
            [x.to(self.devices[0]) for x in xs]), op))

    def allgather(self, tensors):
        xs = self._inputs(tensors)
        if self._nccl:
            from torch.cuda import nccl

            outs = [torch.empty((self.world_size,) + x.shape, dtype=x.dtype,
                                device=x.device) for x in xs]
            nccl.all_gather(xs, outs)
            return outs
        return self._spread(torch.stack([x.to(self.devices[0])
                                         for x in xs]))

    def reducescatter(self, tensors, op: ReduceOp = ReduceOp.SUM):
        xs = self._inputs(tensors)
        n = xs[0].shape[0]
        if n % self.world_size:
            raise ValueError(f"reducescatter dim {n} not divisible by "
                             f"world size {self.world_size}")
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise NotImplementedError(f"reducescatter op {op}")
        chunk = n // self.world_size
        if self._nccl:
            from torch.cuda import nccl

            outs = [torch.empty((chunk,) + x.shape[1:], dtype=x.dtype,
                                device=x.device) for x in xs]
            nccl.reduce_scatter(xs, outs, op=_NCCL_OPS[ReduceOp.SUM])
        else:
            full = torch.stack([x.to(self.devices[0]) for x in xs]).sum(0)
            outs = [full[r * chunk:(r + 1) * chunk].to(d, copy=True)
                    for r, d in enumerate(self.devices)]
        if op == ReduceOp.AVG:
            outs = [o / self.world_size for o in outs]
        return outs

    def broadcast(self, tensors, src_rank: int = 0):
        xs = self._inputs(tensors)
        if self._nccl:
            from torch.cuda import nccl

            nccl.broadcast(xs, root=src_rank)
            return xs
        return self._spread(xs[src_rank])

    def permute(self, tensors, perm: List[tuple]):
        """ppermute, the primitive under ring algorithms: rank ``dst``
        gets rank ``src``'s tensor for each ``(src, dst)``; a rank no pair
        sends to gets zeros."""
        xs = self._inputs(tensors)
        outs = [torch.zeros_like(x) for x in xs]
        for src, dst in perm:
            outs[dst] = xs[src].to(self.devices[dst], copy=True)
        return outs

    def barrier(self):
        self.allreduce([torch.zeros(1) for _ in range(self.world_size)])


# -------------------------------------------------------------------- store


_COORD_NAME_FMT = "_rtpu_collective_coord:{}"


class _Coordinator:
    """Named rendezvous/mailbox actor (one per group).

    Non-blocking: ranks contribute values and poll for completion, so the
    actor's serial execution loop never stalls. On the in-process runtime
    its methods run in the callers' threads, so a lock serialises them.
    """

    # Completed slots / delivered mail are kept in bounded caches so a
    # retried collect/take returns the same result instead of None: every
    # coordinator op is idempotent, which lets clients use bounded, retried
    # calls without losing data.
    _DONE_CACHE = 256

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        self._slots: Dict[str, dict] = {}
        self._mail: Dict[str, Any] = {}
        self._done_slots: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._delivered: "collections.OrderedDict" = \
            collections.OrderedDict()
        # Gang poisoning: once set (by the gang supervisor on member death,
        # or by any member that noticed a peer die), every member's poison
        # watcher sees it within one heartbeat and pending collectives
        # raise GangMemberDiedError instead of waiting out the op deadline.
        self._poison: Optional[str] = None

    def poison(self, reason: str) -> bool:
        """Mark the whole group dead. Idempotent; first reason wins."""
        with self._lock:
            if self._poison is None:
                self._poison = str(reason) or "gang poisoned"
        return True

    def poison_status(self) -> Optional[str]:
        return self._poison

    @staticmethod
    def _cache_put(cache, key, value, cap):
        cache[key] = value
        while len(cache) > cap:
            cache.popitem(last=False)

    def contribute(self, key: str, rank: int, value):
        with self._lock:
            slot = self._slots.setdefault(key, {"vals": {}, "taken": set()})
            slot["vals"][rank] = value  # idempotent: same rank overwrites
            return len(slot["vals"])

    def collect(self, key: str, rank: int):
        """All contributions once complete; the slot moves to a bounded
        done-cache after every rank collected, so late retries still see
        the result."""
        with self._lock:
            slot = self._slots.get(key)
            if slot is None:
                return self._done_slots.get(key)
            if len(slot["vals"]) < self.world_size:
                return None
            vals = [slot["vals"][r] for r in range(self.world_size)]
            slot["taken"].add(rank)
            if len(slot["taken"]) >= self.world_size:
                self._slots.pop(key, None)
                self._cache_put(self._done_slots, key, vals,
                                self._DONE_CACHE)
            return vals

    def post(self, key: str, value):
        with self._lock:
            self._mail[key] = value  # idempotent
        return True

    def take(self, key: str):
        with self._lock:
            val = self._mail.pop(key, None)
            if val is not None:
                self._cache_put(self._delivered, key, val, self._DONE_CACHE)
                return val
            return self._delivered.get(key)  # retried take after delivery


class StoreGroup(BaseGroup):
    """Cross-process group over the runtime's object transport (numpy on
    the wire)."""

    def __init__(self, world_size: int, rank: int, group_name: str, *,
                 runtime: Any = None):
        super().__init__(world_size, rank, group_name)
        self._init_state(runtime)
        rt = self._rt
        name = _COORD_NAME_FMT.format(group_name)
        if rank == 0:
            coord_cls = rt.remote(_Coordinator)
            try:
                self._coord = coord_cls.options(
                    name=name, lifetime="detached").remote(world_size)
            except Exception as e:
                # Lost the create race (re-formed gang, parallel rank 0):
                # attach to the winner. get_actor raising here (the failure
                # was NOT a name race) is the real error.
                logger.debug("coordinator create for %s raced (%s); "
                             "attaching to the existing actor", name, e)
                self._coord = rt.get_actor(name)
        else:
            deadline = time.time() + self._rendezvous_timeout_s
            while True:
                try:
                    self._coord = rt.get_actor(name)
                    break
                except Exception:
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"collective group '{group_name}' rendezvous "
                            f"timed out waiting for rank 0")
                    time.sleep(0.05)
        if world_size > 1:
            self._watcher = threading.Thread(
                target=self._poison_watch_loop, daemon=True,
                name=f"rtpu-gang-watch-{group_name}")
            self._watcher.start()

    def _init_state(self, runtime: Any) -> None:
        self._rt = _runtime(runtime)
        self._get_timeout_error, self._actor_error = _runtime_errors(
            self._rt)
        self._coord = None
        self._seq = 0
        # p2p sequence numbers are per (src, dst) channel: sender and
        # receiver each count that channel's ops.
        self._p2p_seq: Dict[tuple, int] = {}
        self._op_timeout_s = float(config.collective_op_timeout_s)
        self._rendezvous_timeout_s = float(
            config.collective_rendezvous_timeout_s)
        self._heartbeat_s = max(0.05, float(config.gang_heartbeat_s))
        # Poison state: set by the watcher (polling the coordinator's flag
        # every heartbeat) or locally when a peer failure is observed.
        self._poisoned: Optional[str] = None
        self._destroyed = threading.Event()
        # Before the watcher starts: _on_poisoned_wedged reads it.
        self._op_inflight_since: Optional[float] = None

    # ------------------------------------------------------ gang poisoning

    def _check_poison(self):
        if self._poisoned is not None:
            raise GangMemberDiedError(group_name=self.group_name,
                                      reason=self._poisoned)

    def _mark_poisoned(self, reason: str):
        if self._poisoned is None:
            self._poisoned = reason

    def poisoned(self) -> Optional[str]:
        return self._poisoned

    def _on_poisoned_wedged(self):
        """Hook: backend-specific unwedge once poison is observed while an
        op is still in flight (torch_dist aborts its world)."""

    def _poison_watch_loop(self):
        """Poll the coordinator's poison flag every gang heartbeat; pending
        ops check ``self._poisoned`` at heartbeat granularity, so
        poison-to-GangMemberDiedError is at most about 2x the heartbeat. A
        dead coordinator counts as poison too."""
        while not self._destroyed.wait(self._heartbeat_s):
            if self._poisoned is not None:
                break
            try:
                reason = self._rt.get(self._coord.poison_status.remote(),
                                      timeout=2 * self._heartbeat_s)
            except self._get_timeout_error:
                continue
            except BaseException as e:
                self._mark_poisoned(
                    f"collective coordinator unreachable: {e}")
                break
            if reason is not None:
                self._mark_poisoned(reason)
                break
        if self._poisoned is not None and not self._destroyed.is_set():
            try:
                self._on_poisoned_wedged()
            except Exception:
                logger.warning("poison-wedge teardown failed; survivors "
                               "may stay blocked until the op deadline",
                               exc_info=True)

    # Every coordinator round trip is bounded and retried: one lost call
    # must degrade to one extra poll, not hang the collective.
    _POLL_RPC_TIMEOUT_S = 10.0

    def _coord_call(self, fut_factory, deadline: float, tag: str):
        window = min(self._POLL_RPC_TIMEOUT_S, self._heartbeat_s)
        stale_limit = max(1, int(3 * self._POLL_RPC_TIMEOUT_S / window))
        self._check_poison()
        ref = fut_factory()
        stale = 0
        while True:
            self._check_poison()
            left = deadline - time.time()
            if left <= 0:
                raise TimeoutError(f"collective op {tag} timed out")
            try:
                return self._rt.get(ref, timeout=min(window, left))
            except self._get_timeout_error:
                # Keep waiting on the same call first; after a few windows
                # resubmit (every coordinator op is idempotent).
                stale += 1
                if stale >= stale_limit:
                    stale = 0
                    ref = fut_factory()
                continue
            except self._actor_error as e:
                # The coordinator died with a gang member (or the group was
                # torn down): poison locally so every pending op unwedges.
                self._mark_poisoned(f"collective coordinator died: {e}")
                raise GangMemberDiedError(
                    group_name=self.group_name,
                    reason=self._poisoned) from e

    def _exchange(self, tag: str, value) -> List[Any]:
        self._seq += 1
        key = f"{tag}:{self._seq}"
        deadline = time.time() + self._op_timeout_s
        self._coord_call(
            lambda: self._coord.contribute.remote(key, self.rank, value),
            deadline, tag)
        while True:
            vals = self._coord_call(
                lambda: self._coord.collect.remote(key, self.rank),
                deadline, tag)
            if vals is not None:
                return vals
            if time.time() > deadline:
                raise TimeoutError(f"collective op {tag} timed out")
            time.sleep(0.002)

    @staticmethod
    def _reduce(arrs: List[np.ndarray], op: ReduceOp) -> np.ndarray:
        stack = np.stack([np.asarray(a) for a in arrs])
        if op == ReduceOp.SUM:
            return stack.sum(axis=0)
        if op == ReduceOp.AVG:
            return stack.mean(axis=0)
        if op == ReduceOp.MAX:
            return stack.max(axis=0)
        if op == ReduceOp.MIN:
            return stack.min(axis=0)
        if op == ReduceOp.PRODUCT:
            return stack.prod(axis=0)
        raise NotImplementedError(op)

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        vals = self._exchange("allreduce", np.asarray(tensor))
        return self._reduce(vals, op)

    def allgather(self, tensor):
        vals = self._exchange("allgather", np.asarray(tensor))
        return np.stack(vals)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        t = np.asarray(tensor)
        if t.shape[0] % self.world_size:
            raise ValueError("reducescatter dim not divisible by world size")
        vals = self._exchange("reducescatter", t)
        full = self._reduce(vals, op)
        chunk = t.shape[0] // self.world_size
        return full[self.rank * chunk:(self.rank + 1) * chunk]

    def broadcast(self, tensor, src_rank: int = 0):
        payload = np.asarray(tensor) if self.rank == src_rank else None
        vals = self._exchange("broadcast", payload)
        return vals[src_rank]

    def barrier(self):
        self._exchange("barrier", None)

    def _need_coordinator(self):
        if self._coord is None:
            raise RuntimeError(
                f"group '{self.group_name}' has no coordinator (its ranks "
                f"met at a given address): send/recv need one")

    def send(self, tensor, dst_rank: int):
        self._need_coordinator()
        chan = (self.rank, dst_rank)
        seq = self._p2p_seq.get(chan, 0) + 1
        self._p2p_seq[chan] = seq
        key = f"p2p:{self.rank}->{dst_rank}:{seq}"
        payload = np.asarray(tensor)
        self._coord_call(lambda: self._coord.post.remote(key, payload),
                         time.time() + self._op_timeout_s, "send")

    def recv(self, shape, dtype, src_rank: int):
        self._need_coordinator()
        chan = (src_rank, self.rank)
        seq = self._p2p_seq.get(chan, 0) + 1
        self._p2p_seq[chan] = seq
        key = f"p2p:{src_rank}->{self.rank}:{seq}"
        deadline = time.time() + self._op_timeout_s
        while True:
            val = self._coord_call(lambda: self._coord.take.remote(key),
                                   deadline, "recv")
            if val is not None:
                return np.asarray(val, dtype=dtype).reshape(shape)
            if time.time() > deadline:
                raise TimeoutError("recv timed out")
            time.sleep(0.002)

    def destroy(self):
        self._destroyed.set()
        if self.rank == 0 and self._coord is not None:
            try:
                self._rt.kill(self._coord)
            # A coordinator already dead (gang death) is the expected
            # failure here, and destroy() must never fail a teardown.
            except Exception:
                pass


# -------------------------------------------------------------- torch_dist


_world_lock = threading.Lock()
_world_users = 0


def _node_address(rt: Any) -> str:
    """This process's host as the runtime's other nodes reach it: the host
    of its node manager's ``host:port`` where the runtime lists its nodes
    (``nodes()``, as the ``ray_tpu`` module does), else the loopback, which
    is all the in-process runtime's one process needs."""
    nodes = getattr(rt, "nodes", None)
    if nodes is not None:
        node_id = rt.get_runtime_context().get_node_id()
        for n in nodes():
            if n.get("NodeID") == node_id:
                host, sep, port = str(
                    n.get("NodeManagerAddress", "")).rpartition(":")
                if sep and host and port.isdigit():
                    return host
    return "127.0.0.1"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def join_world(coordinator_address: str, world_size: int, rank: int, *,
               device: DeviceLike = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join (or confirm membership in) this process's ``torch.distributed``
    world at ``tcp://coordinator_address``, NCCL when ``device`` (``cuda``
    by default) is CUDA, gloo when it is the CPU; nothing falls back to the
    other backend. Idempotent per process: a world of the same size, rank
    and backend is reused; one of another raises. ``timeout_s`` (default
    ``collective_op_timeout_s``) bounds the rendezvous and every op.
    Returns the device the world's tensors live on."""
    import torch.distributed as dist

    global _world_users
    dev = _group_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if timeout_s is None:
        timeout_s = float(config.collective_op_timeout_s)
    with _world_lock:
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=world_size, rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s))
            _world_users = 0
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"torch.distributed world has {dist.get_world_size()} "
                f"processes, expected {world_size}: this process joined "
                f"another world before this group")
        if dist.get_rank() != rank:
            raise RuntimeError(
                f"torch.distributed rank {dist.get_rank()} != group rank "
                f"{rank}")
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"torch.distributed world runs {dist.get_backend()}; a "
                f"group on {dev} needs {backend}")
        _world_users += 1
    return dev


def leave_world() -> None:
    """Drop one ``join_world``; the last one out destroys the world."""
    import torch.distributed as dist

    global _world_users
    with _world_lock:
        _world_users = max(0, _world_users - 1)
        if _world_users == 0 and dist.is_initialized():
            dist.destroy_process_group()


def _abort_world() -> None:
    """Abort this process's world so a pending NCCL op errors out (the
    counterpart of aborting a communicator); where torch has no abort,
    destroy the world."""
    import torch.distributed as dist

    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if abort is not None:
        abort()
    elif dist.is_initialized():
        dist.destroy_process_group()


class TorchDistGroup(StoreGroup):
    """One member process per rank over a ``torch.distributed`` world.

    The dense ops run on tensors on the group's ``device``: NCCL on a CUDA
    device, gloo on the CPU. Numpy values come back as numpy and tensors
    as tensors on the group's device, so ``StoreGroup``'s callers need no
    change. Every rank passes a value of the same shape, ``broadcast``'s
    non-source ranks too. ``send``/``recv`` ride the coordinator's mailbox,
    as the reference's do.
    """

    def __init__(self, world_size: int, rank: int, group_name: str, *,
                 device: DeviceLike = None, runtime: Any = None,
                 address: Optional[str] = None):
        """``address`` is the world's ``host:port`` where the caller already
        knows it, as ``torch.distributed``'s own launchers hand it to
        processes started outside any runtime: the ranks then meet there
        with no coordinator, so the group has no poisoning and no
        ``send``/``recv``."""
        self.device = _group_device(device)
        if address is not None:
            BaseGroup.__init__(self, world_size, rank, group_name)
            self._init_state(runtime)
            join_world(address, world_size, rank, device=self.device)
            return
        super().__init__(world_size, rank, group_name, runtime=runtime)
        try:
            addr_key = f"torchdist_addr:{group_name}"
            rdv = self._rendezvous_timeout_s
            rdv_deadline = time.time() + rdv
            if rank == 0:
                addr = f"{_node_address(self._rt)}:{_free_port()}"
                self._rt.get(self._coord.post.remote(addr_key, addr),
                             timeout=rdv)
            else:
                while True:
                    addr = self._rt.get(self._coord.take.remote(addr_key),
                                        timeout=rdv)
                    if addr is not None:
                        # Re-post for the remaining ranks.
                        self._rt.get(self._coord.post.remote(addr_key, addr),
                                     timeout=rdv)
                        break
                    if time.time() > rdv_deadline:
                        raise TimeoutError(
                            f"group '{group_name}': no world address from "
                            f"rank 0")
                    time.sleep(0.02)
            join_world(addr, world_size, rank, device=self.device)
        except BaseException:
            # Stop the poison watcher of the half-built group.
            self._destroyed.set()
            raise

    # Substrings that mark a failed op as a transport or member failure
    # (a gloo pair closed or timed out, a NCCL communicator aborted): the
    # gang is the failure domain, so they surface as GangMemberDiedError.
    _PEER_FAILURE_MARKERS = (
        "gloo", "nccl", "connection reset", "connection closed",
        "connection refused", "broken pipe", "peer", "timed out",
        "aborted",
    )

    def _run(self, fn, x):
        """``fn`` on a copy of ``x`` on the group's device; the result as
        numpy when ``x`` was not a tensor."""
        self._check_poison()
        t = _as_tensor(x, self.device)
        self._op_inflight_since = time.time()
        try:
            out = fn(t)
        except Exception as e:
            msg = str(e).lower()
            if self._poisoned is not None or any(
                    m in msg for m in self._PEER_FAILURE_MARKERS):
                reason = self._poisoned or f"collective transport failed: {e}"
                self._mark_poisoned(reason)
                raise GangMemberDiedError(
                    group_name=self.group_name, reason=reason) from e
            raise
        finally:
            self._op_inflight_since = None
        self._check_poison()
        return out if isinstance(x, torch.Tensor) else out.cpu().numpy()

    def _on_poisoned_wedged(self):
        """Poison observed: if an op is still pending after a grace of 2x
        the heartbeat (the dead peer will never enter it), abort the world
        so the op errors out. That ends a NCCL op; a gloo op ends at the
        world's timeout (module docstring)."""
        if not bool(config.gang_poison_teardown_enabled):
            return
        deadline = time.time() + 2.0 * self._heartbeat_s
        while time.time() < deadline:
            if self._op_inflight_since is None:
                return   # unwedged on its own (transport error surfaced)
            if self._destroyed.wait(self._heartbeat_s / 4):
                return
        if self._op_inflight_since is not None:
            _abort_world()

    def _sum_then(self, t: torch.Tensor, op: ReduceOp, reduce) -> torch.Tensor:
        """``reduce(t, torch_op)`` with AVG as a sum over the world size
        (gloo has no AVG)."""
        import torch.distributed as dist

        ops = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG:
               dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
               ReduceOp.MIN: dist.ReduceOp.MIN,
               ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}
        out = reduce(t, ops[op])
        if op == ReduceOp.AVG:
            out = (out if out.is_floating_point() else out.double()) \
                / self.world_size
        return out

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        import torch.distributed as dist

        def reduce(t, top):
            dist.all_reduce(t, op=top)
            return t

        return self._run(lambda t: self._sum_then(t, op, reduce), tensor)

    def allgather(self, tensor):
        import torch.distributed as dist

        def gather(t):
            outs = [torch.empty_like(t) for _ in range(self.world_size)]
            dist.all_gather(outs, t)
            return torch.stack(outs)

        return self._run(gather, tensor)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        import torch.distributed as dist

        n = (tensor.shape if isinstance(tensor, torch.Tensor)
             else np.shape(tensor))[0]
        if n % self.world_size:
            raise ValueError("reducescatter dim not divisible by world size")

        def reduce(t, top):
            out = t.new_empty((n // self.world_size,) + t.shape[1:])
            dist.reduce_scatter_tensor(out, t.contiguous(), op=top)
            return out

        return self._run(lambda t: self._sum_then(t, op, reduce), tensor)

    def broadcast(self, tensor, src_rank: int = 0):
        import torch.distributed as dist

        def bcast(t):
            dist.broadcast(t, src=src_rank)
            return t

        return self._run(bcast, tensor)

    def barrier(self):
        self.allreduce(torch.zeros(1, device=self.device))

    def destroy(self):
        super().destroy()
        leave_world()


# ----------------------------------------------------------------- module API


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "local",
    group_name: str = DEFAULT_GROUP_NAME,
    devices: Optional[Sequence[DeviceLike]] = None,
    *,
    device: DeviceLike = None,
    runtime: Any = None,
) -> BaseGroup:
    """Create (or join) a collective group. ``devices`` are a ``local``
    group's, ``device`` a ``torch_dist`` group's (``cuda`` by default);
    ``runtime`` carries a ``store`` or ``torch_dist`` group's coordinator."""
    backend = Backend(backend)
    # Reserve the name under one lock acquisition so two concurrent
    # initializers can't both construct and silently clobber each other.
    with _groups_lock:
        if group_name in _groups:
            raise RuntimeError(f"group '{group_name}' already initialized")
        _groups[group_name] = None  # reservation
    try:
        if backend == Backend.LOCAL:
            g: BaseGroup = LocalGroup(world_size, rank, group_name,
                                      devices=devices)
        elif backend == Backend.TORCH_DIST:
            g = TorchDistGroup(world_size, rank, group_name, device=device,
                               runtime=runtime)
        else:
            g = StoreGroup(world_size, rank, group_name, runtime=runtime)
    except BaseException:
        with _groups_lock:
            _groups.pop(group_name, None)
        raise
    with _groups_lock:
        _groups[group_name] = g
    return g


def is_group_initialized(group_name: str = DEFAULT_GROUP_NAME) -> bool:
    with _groups_lock:
        return _groups.get(group_name) is not None


def get_group(group_name: str = DEFAULT_GROUP_NAME) -> BaseGroup:
    with _groups_lock:
        g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' is not initialized")
    return g


def poison_group(group_name: str, reason: str, timeout_s: float = 10.0, *,
                 runtime: Any = None) -> bool:
    """Poison a group from any process that can reach its coordinator
    (typically the gang's supervisor): every member's watcher sees the flag
    within a heartbeat and pending ops raise GangMemberDiedError. False
    when the coordinator is unreachable (members then detect that through
    their own watchers)."""
    rt = _runtime(runtime)
    try:
        coord = rt.get_actor(_COORD_NAME_FMT.format(group_name))
        rt.get(coord.poison.remote(reason), timeout=timeout_s)
        return True
    except Exception as e:
        logger.debug("poison_group(%s) could not reach the coordinator: %s",
                     group_name, e)
        return False


def destroy_collective_group(group_name: str = DEFAULT_GROUP_NAME):
    with _groups_lock:
        g = _groups.pop(group_name, None)
    if g is not None:
        g.destroy()


def get_rank(group_name: str = DEFAULT_GROUP_NAME) -> int:
    return get_group(group_name).rank


def get_collective_group_size(group_name: str = DEFAULT_GROUP_NAME) -> int:
    return get_group(group_name).world_size


def allreduce(tensor, group_name: str = DEFAULT_GROUP_NAME,
              op: ReduceOp = ReduceOp.SUM):
    return get_group(group_name).allreduce(tensor, op=op)


def allgather(tensor, group_name: str = DEFAULT_GROUP_NAME):
    return get_group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = DEFAULT_GROUP_NAME,
                  op: ReduceOp = ReduceOp.SUM):
    return get_group(group_name).reducescatter(tensor, op=op)


def broadcast(tensor, src_rank: int = 0,
              group_name: str = DEFAULT_GROUP_NAME):
    return get_group(group_name).broadcast(tensor, src_rank=src_rank)


def barrier(group_name: str = DEFAULT_GROUP_NAME):
    return get_group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = DEFAULT_GROUP_NAME):
    return get_group(group_name).send(tensor, dst_rank)


def recv(shape, dtype, src_rank: int, group_name: str = DEFAULT_GROUP_NAME):
    return get_group(group_name).recv(shape, dtype, src_rank)
