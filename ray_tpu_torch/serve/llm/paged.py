"""Host-side KV block-pool accounting for the paged engine (a copy of
``ray_tpu/serve/llm/paged.py``, which imports no JAX; the port keeps its
own copy as it imports nothing of ``ray_tpu``).

The device side (``models/generate.py`` paged functions) only sees flat
pool rows and block tables; WHICH blocks a sequence owns is pure host
bookkeeping, kept here. Block 0 is the scratch block — never allocated,
the redirect target for retired slots and pad writes — so the usable
pool is ``num_blocks - 1`` blocks.

Prefix caching (``prefix_cache=True``) makes blocks SHARED, REFCOUNTED,
CONTENT-ADDRESSED objects — the paper's immutable-shared-object model
pushed down into the KV cache. A full block whose KV was computed for
token-ids ``tokens[i*bs:(i+1)*bs]`` at logical positions
``[i*bs, (i+1)*bs)`` is keyed by the HASH CHAIN of every full block up
to and including it, so a chain lookup walks a prompt block-by-block
until the first miss and two prompts share exactly their common
full-block prefix. Sharing invariants:

- A cached block's KV depends only on the token ids at its positions
  (deterministic forward pass), so any request whose sequence starts
  with the same tokens may attach to it read-only.
- Writes never land in a shared block: the engine only matches FULL
  blocks strictly before the last prompt token, so the divergence-point
  partial block (and the block that produces the first-token logits)
  is always freshly allocated and freshly computed.
- ``release`` (the engine's free path) decrefs; a refcount-0 cached
  block parks on an LRU instead of returning to the free list, so hot
  prefixes survive request churn and are reclaimed (oldest first) only
  when ``alloc`` would otherwise fail. A block with refcount > 0 is
  never evicted.
- Lookups verify TOKEN IDS, not just hashes: each cached block stores
  its own token ids and its parent's chain key, so a hash collision
  degrades to a cache miss, never to cross-request corruption.

Thread-safety: the engine's scheduler thread is the only allocator
caller; ``stats``-style readers tolerate a torn read (ints). No lock.
"""

from __future__ import annotations

import collections
import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

_ROOT_KEY = b"paged-prefix-root"


def _chain_key(parent: bytes, tokens: Tuple[int, ...]) -> bytes:
    """Chain hash of one full block: parent key + this block's token
    ids. Module-level so collision tests can monkeypatch it."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(struct.pack(f"<{len(tokens)}q", *tokens))
    return h.digest()


class BlockPool:
    """Free-list allocator over the shared KV block pool, with an
    optional content-addressed prefix cache on top."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError("paged KV pool needs >= 2 blocks "
                             "(block 0 is scratch)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self._free: List[int] = list(range(1, num_blocks))
        # Membership twin of the free list: the double-free guard must
        # not cost a list scan per freed block (retirement runs on the
        # scheduler thread between decode steps).
        self._free_set = set(self._free)
        self._freed_total = 0
        self._alloc_total = 0
        # --- prefix cache state ------------------------------------------
        self._refs: Dict[int, int] = {}        # block -> refcount (> 0)
        self._chain: Dict[bytes, int] = {}     # chain key -> cached block
        # block -> (chain key, parent key, this block's token ids) —
        # the token ids are what lookups VERIFY (hash-collision safety).
        self._meta: Dict[int, Tuple[bytes, bytes, Tuple[int, ...]]] = {}
        # Cached blocks at refcount 0, insertion order = release order
        # (LRU: eviction pops the longest-idle prefix first).
        self._idle: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._evicted_total = 0

    # ------------------------------------------------------------ alloc

    @property
    def capacity(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    def available(self) -> int:
        return len(self._free)

    def used(self) -> int:
        """Blocks referenced by at least one live sequence. Idle cached
        blocks are NOT used — they are reclaimable on demand."""
        return self.capacity - len(self._free) - len(self._idle)

    def occupancy(self) -> float:
        return self.used() / self.capacity if self.capacity else 0.0

    def cached_blocks(self) -> int:
        """Blocks registered in the prefix chain (idle or referenced)."""
        return len(self._meta)

    def shared_blocks(self) -> int:
        """Blocks currently referenced by more than one sequence."""
        return sum(1 for c in self._refs.values() if c > 1)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` logical positions."""
        return max(0, -(-int(tokens) // self.block_size))

    def can_fit(self, tokens: int) -> bool:
        """Whether ``tokens`` positions could EVER fit (vs the whole
        pool) — admission rejects impossible requests up front instead
        of parking them forever."""
        return self.blocks_for(tokens) <= self.capacity

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks, or None (allocation is all-or-nothing so a
        half-admitted sequence never holds blocks it cannot use). When
        the free list is short, refcount-0 cached blocks are evicted
        LRU-first to make room; in-use (refcount > 0) blocks never
        are."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            self._evict_idle(n - len(self._free))
        if n > len(self._free):
            return None
        out, self._free = self._free[:n], self._free[n:]
        self._free_set.difference_update(out)
        for b in out:
            self._refs[b] = 1
        self._alloc_total += n
        return out

    def _evict_idle(self, need: int) -> None:
        """Reclaim up to ``need`` refcount-0 cached blocks, oldest
        release first."""
        while need > 0 and self._idle:
            b, _ = self._idle.popitem(last=False)
            key, _, _ = self._meta.pop(b)
            del self._chain[key]
            self._free.append(b)
            self._free_set.add(b)
            self._freed_total += 1
            self._evicted_total += 1
            need -= 1

    # ------------------------------------------------------ prefix cache

    def match_prefix(self, tokens: Sequence[int]
                     ) -> Tuple[List[int], int]:
        """Walk the hash chain block-by-block until the first miss.
        Returns (cached blocks, matched token count) WITHOUT taking
        references — pair with ``acquire``. Never matches past the
        last FULL block strictly before the final token: the block
        holding the divergence point / last prompt token is always
        recomputed fresh (the engine needs its logits, and a partial
        block must never be shared)."""
        if not self.prefix_cache or len(tokens) < 2:
            return [], 0
        bs = self.block_size
        limit = (len(tokens) - 1) // bs
        out: List[int] = []
        key = _ROOT_KEY
        for i in range(limit):
            blk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            parent = key
            key = _chain_key(parent, blk)
            b = self._chain.get(key)
            if b is None:
                break
            _, cached_parent, cached_toks = self._meta[b]
            # Verify the token ids (and the parent link), not just the
            # hash: a collision is a miss, never a wrong block.
            if cached_toks != blk or cached_parent != parent:
                break
            out.append(b)
        return out, len(out) * bs

    def acquire(self, blocks: Sequence[int]) -> None:
        """Take a reference on cached blocks returned by
        ``match_prefix`` (pulls refcount-0 blocks off the idle LRU)."""
        for b in blocks:
            self._refs[b] = self._refs.get(b, 0) + 1
            self._idle.pop(b, None)

    def get_or_alloc(self, tokens: Sequence[int], total_blocks: int
                     ) -> Optional[Tuple[List[int], int]]:
        """Admission in one step: match the prompt's cached prefix,
        take references on it, and allocate the remaining
        ``total_blocks - matched`` fresh blocks. Returns
        (blocks, matched_tokens) — the first ``matched_tokens //
        block_size`` entries are shared (attention-read-only) — or
        None with NO references taken when the pool cannot serve the
        suffix even after eviction (all-or-nothing)."""
        cached, matched = self.match_prefix(tokens)
        if len(cached) > total_blocks:     # budget shorter than prefix
            cached = cached[:total_blocks]
            matched = len(cached) * self.block_size
        self.acquire(cached)
        fresh = self.alloc(total_blocks - len(cached))
        if fresh is None:
            self.release(cached)
            return None
        return cached + fresh, matched

    def register(self, tokens: Sequence[int],
                 blocks: Sequence[int]) -> int:
        """Make a prefilled sequence's full blocks findable:
        ``blocks[i]`` must hold the KV of ``tokens[i*bs:(i+1)*bs]`` at
        logical positions ``[i*bs, (i+1)*bs)``. Idempotent: keys
        already in the chain (the request's own matched prefix, or a
        concurrent twin's registration) are skipped. Returns the number
        of newly cached blocks."""
        if not self.prefix_cache:
            return 0
        bs = self.block_size
        added = 0
        key = _ROOT_KEY
        for i in range(len(tokens) // bs):
            blk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            parent = key
            key = _chain_key(parent, blk)
            if key in self._chain:
                continue
            b = blocks[i]
            if b in self._meta:    # already caches some other chain
                continue
            self._chain[key] = b
            self._meta[b] = (key, parent, blk)
            added += 1
        return added

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block (the engine's free path: slot
        retirement, cancel, preemption, poison). At refcount 0 a cached
        block parks on the idle LRU — hot prefixes survive churn — and
        an uncached block returns to the free list."""
        for b in blocks:
            if b == 0 or b >= self.num_blocks:
                raise ValueError(f"releasing invalid block {b}")
            rc = self._refs.get(b)
            if rc is None:
                raise ValueError(f"release of unreferenced block {b}")
            if rc > 1:
                self._refs[b] = rc - 1
                continue
            del self._refs[b]
            if b in self._meta:
                self._idle[b] = None
            else:
                self._free.append(b)
                self._free_set.add(b)
                self._freed_total += 1

    # ------------------------------------------------------------- free

    def free(self, blocks: List[int]) -> None:
        """Unconditional return to the free list (legacy/raw path; the
        engine uses ``release``). Refuses shared blocks — a refcount
        above 1 means another sequence still reads them."""
        for b in blocks:
            if b == 0 or b >= self.num_blocks:
                raise ValueError(f"freeing invalid block {b}")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            if self._refs.get(b, 0) > 1:
                raise ValueError(f"freeing shared block {b} "
                                 f"(refcount {self._refs[b]})")
        for b in blocks:
            self._refs.pop(b, None)
            self._idle.pop(b, None)
            meta = self._meta.pop(b, None)
            if meta is not None:
                del self._chain[meta[0]]
        self._free.extend(blocks)
        self._free_set.update(blocks)
        self._freed_total += len(blocks)

    def stats(self) -> Dict[str, float]:
        return {
            "kv_blocks_total": self.capacity,
            "kv_blocks_used": self.used(),
            "kv_block_occupancy": round(self.occupancy(), 4),
            "kv_blocks_alloc_total": self._alloc_total,
            "kv_blocks_freed_total": self._freed_total,
            "kv_cached_blocks": self.cached_blocks(),
            "kv_shared_blocks": self.shared_blocks(),
            "kv_prefix_evictions_total": self._evicted_total,
        }
