"""Paged KV-cache manager (vLLM-style), shared across pipeline stages.

The driver owns a single logical page table per request (the paper: "all the
workers share the page tables like vLLM").  Physical cache arrays live on the
devices, sharded over the `stage` mesh axis (each stage holds its own layers'
pages); the *page ids* are global and identical on every stage, so one host-side
allocator serves the whole pipeline.

Supports: allocation/free, copy-on-extend block tables, preemption reclaim,
optional prefix caching (hash-chained full pages with refcounts), the
KV idle-rate signal consumed by Token Throttling's UT term, and per-request
export/import for live migration across replicas (DESIGN.md §9): `export_kv`
captures a request's resident token positions, `import_kv` re-maps them onto
freshly-allocated slots of another manager (page geometries may differ —
the mapping is per token, not per page).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class KVExport:
    """Portable description of one request's resident KV (host side).

    `slots` is the source (page, slot) per resident token, in sequence
    order — exactly the index list a device-side gather needs.  The actual
    cache bytes are moved by the execution backend
    (`ExecutionBackend.export_kv_pages`/`import_kv_pages`); this object only
    carries the *addressing* so the destination can re-map slots.
    """

    request_id: str
    num_tokens: int
    page_size: int
    slots: Tuple[Tuple[int, int], ...]


def hash_page(parent_hash: int, token_ids: Tuple[int, ...]) -> int:
    """Position-dependent content hash for prefix caching (hash chain)."""
    return hash((parent_hash,) + token_ids)


@dataclass
class PageInfo:
    page_id: int
    ref_count: int = 0
    prefix_hash: Optional[int] = None  # set only for frozen full pages


class PagedKVManager:
    """Host-side allocator for the paged KV cache.

    Pages are identified by integer id in [0, num_pages).  `page_size` is in
    tokens.  A request's block table maps token position p to page
    `block_table[p // page_size]`, slot `p % page_size`.
    """

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        enable_prefix_caching: bool = False,
    ) -> None:
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_caching = enable_prefix_caching

        self._pages: List[PageInfo] = [PageInfo(i) for i in range(num_pages)]
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # LIFO
        # Evictable prefix-cache pages: hash -> page_id with ref_count == 0.
        self._prefix_index: Dict[int, int] = {}
        self._evictable: Dict[int, None] = {}  # ordered set (LRU) of page ids
        self._block_tables: Dict[str, List[int]] = {}
        # tokens with KV resident, per request (for slot computation)
        self._num_tokens: Dict[str, int] = {}

    # ------------------------------------------------------------------ state
    @property
    def num_free_pages(self) -> int:
        return len(self._free) + len(self._evictable)

    # One pool is one data replica: the scheduler's per-replica view
    # (`ReplicaKVManager`) reduces to the pool itself.
    replicas = 1

    @property
    def pool_pages(self) -> int:
        """Pages of the pool a request lives in."""
        return self.num_pages

    def replica_of(self, request_id: str) -> Optional[int]:
        return 0

    def place(self, request_id: str, allowed: Sequence[int],
              token_ids: Optional[Sequence[int]] = None) -> Optional[int]:
        """The replica a request is admitted to: this pool, if `allowed`."""
        return 0 if 0 in allowed else None

    def unplace(self, request_id: str) -> None:
        pass

    def free_pages_of(self, request_id: str) -> int:
        """Free pages of the pool `request_id` lives in."""
        return self.num_free_pages

    @property
    def kv_free_rate(self) -> float:
        """KV idle rate in [0,1] — the UT input of Token Throttling."""
        return self.num_free_pages / self.num_pages

    def block_table(self, request_id: str) -> List[int]:
        return self._block_tables[request_id]

    def num_tokens(self, request_id: str) -> int:
        return self._num_tokens.get(request_id, 0)

    def has_request(self, request_id: str) -> bool:
        return request_id in self._block_tables

    # ------------------------------------------------------------- allocation
    def pages_needed(self, request_id: str, new_tokens: int) -> int:
        cur = self._num_tokens.get(request_id, 0)
        cur_pages = len(self._block_tables.get(request_id, ()))
        need_pages = -(-(cur + new_tokens) // self.page_size)  # ceil div
        return max(0, need_pages - cur_pages)

    def can_allocate(self, request_id: str, new_tokens: int) -> bool:
        return self.pages_needed(request_id, new_tokens) <= self.num_free_pages

    def allocate(self, request_id: str, new_tokens: int) -> List[Tuple[int, int]]:
        """Extend a request's KV by `new_tokens`; returns (page, slot) per token.

        Raises MemoryError when out of pages — callers must check
        `can_allocate` first (the scheduler preempts instead of failing).
        """
        need = self.pages_needed(request_id, new_tokens)
        if need > self.num_free_pages:
            raise MemoryError(
                f"KV pool exhausted: need {need} pages, free {self.num_free_pages}"
            )
        table = self._block_tables.setdefault(request_id, [])
        self._num_tokens.setdefault(request_id, 0)
        for _ in range(need):
            table.append(self._take_free_page())
        start = self._num_tokens[request_id]
        slots = [
            (table[(start + i) // self.page_size], (start + i) % self.page_size)
            for i in range(new_tokens)
        ]
        self._num_tokens[request_id] += new_tokens
        return slots

    def free(self, request_id: str) -> None:
        """Release all pages of a request (finish or preemption)."""
        table = self._block_tables.pop(request_id, None)
        self._num_tokens.pop(request_id, None)
        if table is None:
            return
        for pid in table:
            self._release_page(pid)

    # -------------------------------------------------------------- migration
    def export_kv(self, request_id: str) -> KVExport:
        """Addressing of a resident request's KV, for live migration."""
        if request_id not in self._block_tables:
            raise KeyError(f"request {request_id} has no resident KV")
        table = self._block_tables[request_id]
        n = self._num_tokens[request_id]
        slots = tuple((table[i // self.page_size], i % self.page_size)
                      for i in range(n))
        return KVExport(request_id=request_id, num_tokens=n,
                        page_size=self.page_size, slots=slots)

    def import_kv(self, export: KVExport) -> List[Tuple[int, int]]:
        """Allocate fresh pages for a migrated-in request and return the
        destination (page, slot) per token — the scatter addresses matching
        `export.slots` gather addresses one-to-one.  Raises MemoryError when
        the pool cannot hold the request (callers should `can_allocate`
        first and fall back to recompute)."""
        rid = export.request_id
        if self.has_request(rid):
            raise ValueError(f"request {rid} already resident here")
        return self.allocate(rid, export.num_tokens)

    # ---------------------------------------------------------- prefix caching
    def match_prefix(self, token_ids: Sequence[int],
                     request_id: Optional[str] = None
                     ) -> Tuple[int, List[int]]:
        """Longest cached prefix in *full pages*: (num_cached_tokens, page_ids).

        Matched pages get their refcount bumped; caller must attach them via
        `adopt_prefix` or release with `release_pages`.  `request_id` names
        the request it is for (one pool: ignored; `ReplicaKVManager`: its
        replica's pool).
        """
        if not self.enable_prefix_caching:
            return 0, []
        matched: List[int] = []
        parent = 0
        for i in range(0, len(token_ids) - self.page_size + 1, self.page_size):
            chunk = tuple(token_ids[i : i + self.page_size])
            h = hash_page(parent, chunk)
            pid = self._prefix_index.get(h)
            if pid is None:
                break
            self._pages[pid].ref_count += 1
            self._evictable.pop(pid, None)
            matched.append(pid)
            parent = h
        return len(matched) * self.page_size, matched

    def peek_prefix(self, token_ids: Sequence[int]) -> int:
        """Length (in tokens) of the longest cached prefix, without side
        effects: refcounts and the LRU order are untouched.  The router's
        cache-affinity probe — safe to call on every candidate replica per
        routing decision."""
        if not self.enable_prefix_caching:
            return 0
        matched = 0
        parent = 0
        for i in range(0, len(token_ids) - self.page_size + 1, self.page_size):
            chunk = tuple(token_ids[i : i + self.page_size])
            h = hash_page(parent, chunk)
            if h not in self._prefix_index:
                break
            matched += 1
            parent = h
        return matched * self.page_size

    def adopt_prefix(self, request_id: str, num_tokens: int, page_ids: List[int]) -> None:
        """Attach matched prefix pages as the head of a fresh block table."""
        assert request_id not in self._block_tables, "adopt before first allocate"
        self._block_tables[request_id] = list(page_ids)
        self._num_tokens[request_id] = num_tokens

    def freeze_full_pages(self, request_id: str, token_ids: Sequence[int]) -> None:
        """Register the request's full pages in the prefix index (post-prefill)."""
        if not self.enable_prefix_caching:
            return
        table = self._block_tables.get(request_id, [])
        parent = 0
        for idx in range(len(token_ids) // self.page_size):
            chunk = tuple(token_ids[idx * self.page_size : (idx + 1) * self.page_size])
            h = hash_page(parent, chunk)
            pid = table[idx]
            info = self._pages[pid]
            if info.prefix_hash is None and h not in self._prefix_index:
                info.prefix_hash = h
                self._prefix_index[h] = pid
            parent = h

    def release_pages(self, page_ids: Sequence[int]) -> None:
        for pid in page_ids:
            self._release_page(pid)

    # -------------------------------------------------------------- internals
    def _take_free_page(self) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            # Evict the least-recently-freed cached prefix page.
            pid, _ = next(iter(self._evictable.items()))
            del self._evictable[pid]
            info = self._pages[pid]
            if info.prefix_hash is not None:
                self._prefix_index.pop(info.prefix_hash, None)
                info.prefix_hash = None
        info = self._pages[pid]
        assert info.ref_count == 0, f"allocating referenced page {pid}"
        info.ref_count = 1
        return pid

    def _release_page(self, pid: int) -> None:
        info = self._pages[pid]
        assert info.ref_count > 0, f"double free of page {pid}"
        info.ref_count -= 1
        if info.ref_count == 0:
            if info.prefix_hash is not None:
                self._evictable[pid] = None  # cached: evictable, not free
            else:
                self._free.append(pid)

    # ------------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Debug/property-test hook: global page accounting must balance."""
        referenced = sum(1 for p in self._pages if p.ref_count > 0)
        in_tables = {pid for t in self._block_tables.values() for pid in t}
        assert len(self._free) + len(self._evictable) + referenced == self.num_pages, (
            len(self._free), len(self._evictable), referenced, self.num_pages
        )
        for pid in in_tables:
            assert self._pages[pid].ref_count > 0, f"page {pid} in table but free"
        free_set = set(self._free) | set(self._evictable)
        assert not (free_set & in_tables), "page simultaneously free and mapped"


class ReplicaKVManager:
    """The KV pools of `replicas` data replicas under one allocator: the
    global view of the scheduler on rank 0 (gLLM's global information).

    Each replica has its own `PagedKVManager` of `num_pages` pages (JAX's
    ``ServeDims.pages`` are per replica), and a request lives in one of them
    from the chunk that admits it (`place`) until it finishes, aborts or is
    preempted, which free only that replica's pages; its block table holds
    that pool's page ids.  `num_pages`, `num_free_pages` and `kv_free_rate`
    are totals over the replicas (Token Throttling's UT input);
    `free_pages_of` and `pool_pages` are one pool's.

    `place` takes, among the replicas allowed, the one with the longest
    cached prefix of the request's prompt, then the most free pages, then
    the lower index, so that placement never loses a prefix hit.  With
    `enable_prefix_caching` every pool keeps its own prefix index (a page
    is shared only inside its pool): `match_prefix`, `adopt_prefix`,
    `freeze_full_pages` and `release_pages` act on the pool the request
    lives in, and `match_prefix` / `peek_prefix` without a request on the
    pool `place` would pick.  `export_kv` is the pool's; `import_kv` places
    the request by the same rule (a `KVExport` names no replica)."""

    def __init__(self, replicas: int, num_pages: int, page_size: int,
                 enable_prefix_caching: bool = False) -> None:
        if replicas < 1:
            raise ValueError("at least one replica")
        self.pools = [PagedKVManager(num_pages, page_size,
                                     enable_prefix_caching)
                      for _ in range(replicas)]
        self.page_size = page_size
        self.pool_pages = num_pages
        self.num_pages = num_pages * replicas
        self.enable_prefix_caching = enable_prefix_caching
        self._home: Dict[str, int] = {}

    @property
    def replicas(self) -> int:
        return len(self.pools)

    @property
    def num_free_pages(self) -> int:
        return sum(p.num_free_pages for p in self.pools)

    @property
    def kv_free_rate(self) -> float:
        return self.num_free_pages / self.num_pages

    # ------------------------------------------------------------ placement
    def replica_of(self, request_id: str) -> Optional[int]:
        """The replica a request lives in; None before `place`."""
        return self._home.get(request_id)

    def _best(self, allowed: Sequence[int],
              token_ids: Optional[Sequence[int]]) -> int:
        """The longest cached prefix of `token_ids`, then the most free
        pages, then the lower index."""
        def key(r: int):
            pool = self.pools[r]
            hit = pool.peek_prefix(token_ids) if token_ids else 0
            return (hit, pool.num_free_pages, -r)
        return max(allowed, key=key)

    def place(self, request_id: str, allowed: Sequence[int],
              token_ids: Optional[Sequence[int]] = None) -> Optional[int]:
        """The replica `request_id` lives in, placing it among `allowed`
        (`_best` for its prompt `token_ids`) if it lives in none; None when
        its replica, or every replica, is not allowed."""
        home = self._home.get(request_id)
        if home is not None:
            return home if home in allowed else None
        if not allowed:
            return None
        home = self._best(allowed, token_ids)
        self._home[request_id] = home
        return home

    def unplace(self, request_id: str) -> None:
        """Forget a placement that holds no pages (an admission that
        stalled)."""
        home = self._home.get(request_id)
        if home is not None and not self.pools[home].has_request(request_id):
            del self._home[request_id]

    def _pool(self, request_id: str) -> PagedKVManager:
        return self.pools[self._home[request_id]]

    # ----------------------------------------- `PagedKVManager`'s interface
    def free_pages_of(self, request_id: str) -> int:
        return self._pool(request_id).num_free_pages

    def block_table(self, request_id: str) -> List[int]:
        return self._pool(request_id).block_table(request_id)

    def num_tokens(self, request_id: str) -> int:
        home = self._home.get(request_id)
        return 0 if home is None else self.pools[home].num_tokens(request_id)

    def has_request(self, request_id: str) -> bool:
        home = self._home.get(request_id)
        return home is not None and self.pools[home].has_request(request_id)

    def pages_needed(self, request_id: str, new_tokens: int) -> int:
        return self._pool(request_id).pages_needed(request_id, new_tokens)

    def can_allocate(self, request_id: str, new_tokens: int) -> bool:
        home = self._home.get(request_id)
        if home is None:            # a migration's probe: where it would go
            home = self._best(range(self.replicas), None)
        return self.pools[home].can_allocate(request_id, new_tokens)

    def allocate(self, request_id: str,
                 new_tokens: int) -> List[Tuple[int, int]]:
        return self._pool(request_id).allocate(request_id, new_tokens)

    def free(self, request_id: str) -> None:
        """Release a request's pages in its replica, and its placement."""
        home = self._home.pop(request_id, None)
        if home is not None:
            self.pools[home].free(request_id)

    # ------------------------------------------------------------ migration
    def export_kv(self, request_id: str) -> KVExport:
        """`PagedKVManager.export_kv` of the request's pool."""
        if request_id not in self._home:
            raise KeyError(f"request {request_id} has no resident KV")
        return self._pool(request_id).export_kv(request_id)

    def import_kv(self, export: KVExport) -> List[Tuple[int, int]]:
        """Place a migrated-in request (the most free pages, as `place`
        rules) and allocate its tokens there: `PagedKVManager.import_kv`."""
        rid = export.request_id
        if self.has_request(rid):
            raise ValueError(f"request {rid} already resident here")
        self.place(rid, range(self.replicas))
        try:
            return self._pool(rid).import_kv(export)
        except MemoryError:
            self.unplace(rid)
            raise

    # ------------------------------------------------------- prefix caching
    def _probe_pool(self, token_ids: Sequence[int],
                    request_id: Optional[str]) -> PagedKVManager:
        home = None if request_id is None else self._home.get(request_id)
        if home is None:
            home = self._best(range(self.replicas), token_ids)
        return self.pools[home]

    def match_prefix(self, token_ids: Sequence[int],
                     request_id: Optional[str] = None
                     ) -> Tuple[int, List[int]]:
        """`PagedKVManager.match_prefix` in the pool `request_id` lives in
        (or the pool `place` would pick): its page ids."""
        return self._probe_pool(token_ids, request_id).match_prefix(
            token_ids)

    def peek_prefix(self, token_ids: Sequence[int],
                    request_id: Optional[str] = None) -> int:
        """`PagedKVManager.peek_prefix`, as `match_prefix` picks the pool."""
        return self._probe_pool(token_ids, request_id).peek_prefix(token_ids)

    def adopt_prefix(self, request_id: str, num_tokens: int,
                     page_ids: List[int]) -> None:
        self._pool(request_id).adopt_prefix(request_id, num_tokens, page_ids)

    def freeze_full_pages(self, request_id: str,
                          token_ids: Sequence[int]) -> None:
        self._pool(request_id).freeze_full_pages(request_id, token_ids)

    def release_pages(self, page_ids: Sequence[int],
                      request_id: str) -> None:
        """Release matched pages in the pool of `request_id` (placed)."""
        self._pool(request_id).release_pages(page_ids)

    def check_invariants(self) -> None:
        """Each replica's page accounting (refcounts, free lists and its
        prefix index) balances, and every request with pages lives in the
        replica that holds them."""
        for r, pool in enumerate(self.pools):
            pool.check_invariants()
            for rid in pool._block_tables:
                assert self._home.get(rid) == r, (rid, r, self._home.get(rid))
            held: Dict[int, int] = {}
            for table in pool._block_tables.values():
                for pid in table:
                    held[pid] = held.get(pid, 0) + 1
            for info in pool._pages:
                assert info.ref_count == held.get(info.page_id, 0), (
                    r, info.page_id, info.ref_count)
            for h, pid in pool._prefix_index.items():
                assert pool._pages[pid].prefix_hash == h, (r, pid)
            for pid in pool._evictable:
                info = pool._pages[pid]
                assert info.ref_count == 0 and info.prefix_hash is not None, (
                    r, pid)
