"""Physical KV-cache block accounting for the paged decode engine — the
port's own copy of paddle_tpu/serving/kv_blocks.py (host code, the same
semantics; the port imports nothing of the JAX package).

The paged cache (ops/kv_cache_ops.py paged variants) is a pool of
fixed-size physical blocks addressed through per-slot block tables fed to
every step. Two host-side structures own the pool:

- ``BlockAllocator``: free-list + per-block refcounts over blocks
  ``1..num_blocks-1`` (block 0 is the TRASH block — table filler and
  pad-write target — and is never handed out). Admission becomes a
  blocks-available decision; a finished or evicted request's ``deref``
  returns refcount-0 blocks to the free list.
- ``PrefixCache``: content-addressed map from prompt-prefix CHAIN hashes
  (one per full block of prompt tokens) to the physical block already
  holding that prefix's K/V. A hit maps the new request's leading table
  entries onto the SAME physical blocks (refcount++), so an identical
  system prompt is stored once and its prefill computed once. The cache
  itself holds one reference per registered block, so prefix blocks
  survive their creator request and are reclaimed lazily,
  LRU-deepest-first, only under allocation pressure.

Sharing is at FULL-BLOCK granularity. Because a block's K/V rows depend
only on tokens at or before them (causal), a block fully covered by
prompt tokens is immutable once prefilled — the one exception is a
request whose ENTIRE prompt lands on shared blocks (prompt length a
multiple of block_size and all blocks hit): its last prompt position
must be recomputed to produce the first token, which makes its final
block's row a divergent write, so the engine copies that block first
(copy-on-write, ``kv_block_cow_total``) and writes into the private
copy. Neither sharer ever observes the other's tokens.
"""
import hashlib
import threading

__all__ = ['BlockAllocator', 'PrefixCache', 'QuotaBlockAllocator',
           'chain_hashes']


def chain_hashes(tokens, block_size):
    """One chained content hash per FULL block of `tokens`: hash i
    commits to every token in blocks 0..i, so equal hash means equal
    whole prefix (not just an equal i-th block)."""
    out, h = [], b'kv-prefix'
    n_full = len(tokens) // block_size
    for i in range(n_full):
        blk = tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.sha1(
            h + b'|' + b','.join(b'%d' % int(t) for t in blk)).digest()
        out.append(h)
    return out


class BlockAllocator(object):
    """Free-list + refcount accounting over `num_blocks` physical blocks.
    Block 0 is reserved (trash) and never allocated; `capacity` is the
    usable pool size (num_blocks - 1).

    Thread-safe: a fleet hands per-tenant `QuotaBlockAllocator` views
    over ONE pool to multiple decode-loop threads, so every mutation
    (and every check that gates one) runs under the pool's reentrant
    `lock` — views take the SAME lock so their quota check-and-charge
    is atomic against concurrent tenants."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ValueError(
                "paged cache needs >= 2 physical blocks (block 0 is the "
                "reserved trash block), got %d" % num_blocks)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.lock = threading.RLock()
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks

    @property
    def capacity(self):
        return self.num_blocks - 1

    def available(self):
        with self.lock:
            return len(self._free)

    def in_use(self):
        with self.lock:
            return self.capacity - len(self._free)

    def refcount(self, bid):
        with self.lock:
            return self._ref[bid]

    def alloc(self, n):
        """n fresh blocks at refcount 1, or None when the free list is
        short (nothing is partially allocated on failure)."""
        with self.lock:
            if n > len(self._free):
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def ref(self, bid):
        with self.lock:
            if self._ref[bid] < 1:
                raise ValueError("ref of unallocated block %d" % bid)
            self._ref[bid] += 1

    def deref(self, bid):
        """Drop one reference; a refcount-0 block returns to the free
        list. Returns True when the block was actually freed."""
        with self.lock:
            if self._ref[bid] < 1:
                raise ValueError("deref of unallocated block %d" % bid)
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                self._free.append(bid)
                return True
            return False

    def deref_many(self, bids):
        """`deref` a batch (slot release, speculative-tail rollback);
        returns how many blocks actually went back to the free list."""
        with self.lock:
            freed = 0
            for b in bids:
                if self.deref(b):
                    freed += 1
            return freed


class QuotaBlockAllocator(object):
    """A per-tenant VIEW over a shared ``BlockAllocator`` pool: the same
    interface a `GenerateEngine` allocates through, bounded by `quota`
    DISTINCT physical blocks. Multiple tenants resident in one process
    (engines given ``block_allocator=`` views) each hold a view over the
    one pool sized to the real HBM budget; a tenant's admission/growth then competes only inside
    its quota and the pool's free list — one tenant can never allocate
    the pool empty past its own share.

    Accounting: a view is charged one unit per DISTINCT block it holds
    at least one reference to (extra refs to an owned block — the
    within-tenant prefix-sharing case — consume no additional physical
    blocks and are not double-charged). ``in_use()`` is the tenant's
    footprint, ``capacity`` its quota, ``available()`` the admission
    headroom = min(pool free, quota remaining). Eviction isolation is
    structural: each tenant's `PrefixCache` is built over its own view,
    so ``evict_for`` under one tenant's allocation pressure only ever
    walks (and derefs) that tenant's entries.

    Every view method runs under the POOL's reentrant lock (the quota
    check and the pool mutation must be one atomic step — two tenants'
    decode threads race on the same free list otherwise)."""

    def __init__(self, pool, quota, tenant=None):
        quota = int(quota)
        if quota < 1:
            raise ValueError("block quota must be >= 1, got %d" % quota)
        self.pool = pool
        self.quota = quota
        self.tenant = tenant
        self.block_size = pool.block_size
        self.lock = pool.lock
        self._held = {}         # block id -> refs held through this view

    @property
    def capacity(self):
        return min(self.quota, self.pool.capacity)

    def available(self):
        with self.lock:
            return max(0, min(self.pool.available(),
                              self.quota - len(self._held)))

    def in_use(self):
        with self.lock:
            return len(self._held)

    def refcount(self, bid):
        return self.pool.refcount(bid)

    def alloc(self, n):
        with self.lock:
            if len(self._held) + n > self.quota:
                return None
            out = self.pool.alloc(n)
            if out is not None:
                for b in out:
                    self._held[b] = 1
            return out

    def ref(self, bid):
        with self.lock:
            if bid not in self._held and len(self._held) >= self.quota:
                raise ValueError(
                    "ref of block %d would exceed tenant %r quota %d"
                    % (bid, self.tenant, self.quota))
            self.pool.ref(bid)
            self._held[bid] = self._held.get(bid, 0) + 1

    def deref(self, bid):
        with self.lock:
            held = self._held.get(bid, 0)
            if held < 1:
                raise ValueError(
                    "deref of block %d not held by tenant %r"
                    % (bid, self.tenant))
            if held == 1:
                del self._held[bid]
            else:
                self._held[bid] = held - 1
            return self.pool.deref(bid)

    def deref_many(self, bids):
        with self.lock:
            freed = 0
            for b in bids:
                if self.deref(b):
                    freed += 1
            return freed


class PrefixCache(object):
    """hash-chain -> physical block map with LRU pressure eviction.

    Each registered block carries ONE cache reference (so it outlives
    its creator request). `match` walks the chain from depth 0 and
    returns the longest cached run; `evict_for` releases stale entries
    — least-recently-used first, deepest entry first within a tie, so a
    chain never loses a shallow link before its deeper ones — until the
    allocator can satisfy a request, and is only called under
    allocation pressure."""

    def __init__(self, alloc):
        self._alloc = alloc
        self._entries = {}      # hash -> [block_id, depth, last_used]
        self._clock = 0

    def __len__(self):
        return len(self._entries)

    def match(self, hashes):
        """Longest cached prefix run for `hashes` (chain order): the
        list of physical block ids, NOT yet referenced — the caller
        refs the ones it keeps."""
        self._clock += 1
        out = []
        for i, h in enumerate(hashes):
            e = self._entries.get(h)
            if e is None or e[1] != i:      # depth-checked: chains only
                break                       # ever match from the root
            e[2] = self._clock
            out.append(e[0])
        return out

    def register(self, h, depth, block_id):
        """Publish `block_id` as the home of chain hash `h` (depth =
        its block index within the prompt). First writer wins — an
        already-registered hash keeps its existing block."""
        if h in self._entries:
            return False
        self._clock += 1
        self._alloc.ref(block_id)
        self._entries[h] = [block_id, int(depth), self._clock]
        return True

    def evict_for(self, n_needed):
        """Drop cache-only entries (block refcount 1 — no live slot)
        until the allocator has `n_needed` free blocks. Returns the
        number of entries evicted."""
        if self._alloc.available() >= n_needed:
            return 0
        victims = sorted(self._entries.items(),
                         key=lambda kv: (kv[1][2], -kv[1][1]))
        evicted = 0
        for h, (bid, _depth, _used) in victims:
            if self._alloc.available() >= n_needed:
                break
            if self._alloc.refcount(bid) == 1:   # only the cache holds it
                del self._entries[h]
                self._alloc.deref(bid)
                evicted += 1
        return evicted

    def drop_all(self):
        """Release every cached entry (engine shutdown)."""
        for h, (bid, _d, _u) in list(self._entries.items()):
            del self._entries[h]
            self._alloc.deref(bid)
