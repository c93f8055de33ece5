"""Automatic prefix cache: a radix/trie index over the paged KV cache.

Role model: vLLM's automatic prefix caching / SGLang's RadixAttention — the
mechanism that makes the shared-system-prompt workload (N requests over one
long common prefix) pay prefill once instead of N times.

Design
------
The unit of sharing is one **full KV block** (``block_size`` tokens). Each
trie node represents one block's worth of tokens and is keyed by a *chained*
content hash: ``digest(node) = sha1(digest(parent) + token_bytes(block))``, so
a node's identity pins the entire token prefix up to and including its block —
two prompts share a node iff they share every token up to that block boundary.

Ownership is reference counts on the :class:`~.blocked_allocator.BlockedAllocator`:

- the **trie holds one reference** on every block it indexes;
- every live sequence holds one reference on each block in its table (its
  private blocks arrive at refcount 1 from ``allocate``; shared prefix blocks
  are increffed by :meth:`acquire`);
- a sequence flush *decrefs* (``kv_cache.free``), so publishing a finished
  sequence's blocks and then flushing it leaves exactly the trie's reference;
- evicting a trie leaf decrefs once — the device block is reclaimed only when
  no live sequence still maps it.

Writes never touch shared blocks: a hit is block-aligned, so the suffix's KV
scatters land in freshly-allocated blocks — except a **fully-cached prompt**,
whose re-fed final token would write into the last shared block; the scheduler
forks that block copy-on-write (``kv_cache.fork_blocks``) before mapping it.

Eviction is LRU over *evictable leaves*: leaf nodes whose block has refcount 1
(the trie's own — no live sharer; freeing a shared leaf reclaims nothing).
Interior nodes become evictable once their children go.

Thread model: all mutation happens on the serving scheduler's thread (the
engine-owning thread); the stats snapshot reads scalar counters and is safe
from any thread.

Port of ``deepspeed_tpu/inference/v2/ragged/prefix_cache.py`` (host numpy and
``hashlib``; ``digest_chain`` and ``DIGEST_HEX`` are the reference's byte for
byte, so both packages' tries and a fleet router agree on every digest). The
blocks it moves are the port's torch KV cache's; demoted nodes live in its
tiered store as pinned host tensors or spill files.
"""

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

DIGEST_HEX = 16
"""Truncated-hex width of a digest as published in probe docs / fleet stats.
64 bits is plenty for a routing *hint* (the worst a collision costs is one
misrouted dispatch that then misses locally); the fetch path always matches
full 20-byte digests."""


def digest_chain(tokens, block_size: int,
                 base: Optional[List[bytes]] = None) -> List[bytes]:
    """Chained sha1 digests of every *full* ``block_size`` run of ``tokens``:
    ``digest[i] = sha1(digest[i-1] + token_bytes(block_i))``. The one hashing
    authority — :meth:`PrefixCache.chain` and the fleet router's cache-aware
    placement both call this, so a replica's published catalog and the
    router's request chain can never disagree on the algorithm. ``base``
    seeds the chain with already-computed leading digests."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    n_full = tokens.size // block_size
    out = list(base[:n_full]) if base else []
    digest = out[-1] if out else b""
    for i in range(len(out), n_full):
        h = hashlib.sha1()
        h.update(digest)
        h.update(np.ascontiguousarray(
            tokens[i * block_size:(i + 1) * block_size],
            dtype=np.int32).tobytes())
        digest = h.digest()
        out.append(digest)
    return out


class _Node:
    __slots__ = ("digest", "block", "parent", "children", "last_touch",
                 "tokens", "tier", "handle")

    def __init__(self, digest: bytes, block: int, parent: Optional["_Node"],
                 tokens: Optional[np.ndarray] = None):
        self.digest = digest
        self.block = block          # device block id this node owns a ref on
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.last_touch = 0
        # the block's token ids (host copy): what a prompt-lookup drafter
        # mines — the trie holds exactly the token histories it wants
        self.tokens = tokens
        # tier ladder state (ragged.tiering.TIERS): a "device" node owns a
        # trie reference on `block`; a demoted node owns `handle` in the
        # tiered store instead (block is -1) and promotes back on the next
        # acquire that walks through it
        self.tier = "device"
        self.handle: Optional[int] = None


class PrefixHit:
    """A successful :meth:`PrefixCache.acquire`: ``blocks`` are device block
    ids (one reference each now held on the caller's behalf) covering
    ``tokens`` leading prompt tokens."""

    __slots__ = ("blocks", "tokens")

    def __init__(self, blocks: List[int], tokens: int):
        self.blocks = blocks
        self.tokens = tokens


class PrefixCache:
    """Radix index + refcount choreography over one :class:`BlockedKVCache`.

    ``max_blocks`` caps how many device blocks the trie may pin (None = the
    whole pool — under KV pressure the scheduler evicts trie leaves before
    touching live sequences, so an uncapped trie is backpressured naturally).
    ``min_prefix_blocks`` is the smallest match worth applying: shorter hits
    return empty (the bookkeeping would cost more than the saved prefill).
    """

    def __init__(self, kv_cache, max_blocks: Optional[int] = None,
                 min_prefix_blocks: int = 1):
        self._kv = kv_cache
        self._block_size = kv_cache.block_size
        self._max_blocks = max_blocks
        self._min_prefix_blocks = max(1, int(min_prefix_blocks))
        self._root = _Node(b"", -1, None)
        self._by_digest: Dict[bytes, _Node] = {}
        # guards _by_digest's structure only: mutation stays on the scheduler
        # thread, but digest_catalog() snapshots from probe threads
        self._index_lock = threading.Lock()
        self._clock = 0  # monotonic LRU counter (no wall clock: deterministic)
        self._device_nodes = 0  # nodes whose tier is "device" (pinned blocks)
        # stats (read lock-free from stats threads; written on scheduler thread)
        self.lookups = 0
        self.hits = 0
        self.hit_blocks = 0
        self.tokens_served = 0   # prompt tokens served from cache
        self.evictions = 0       # trie leaves evicted (blocks unpinned)
        self.published_blocks = 0
        self.tier_demotions = 0   # nodes moved device→store (host tier)
        self.tier_promotions = 0  # nodes moved store→device on acquire
        self.promote_failures = 0  # promotions lost to device pressure

    # ------------------------------------------------------------- hashing --
    def chain(self, tokens, base: Optional[List[bytes]] = None) -> List[bytes]:
        """Chained digests of every *full* block of ``tokens``. ``base`` seeds
        the chain with digests already computed for the leading blocks (the
        scheduler hashes each prompt once at admission and extends over the
        generated tail at publish time, instead of re-hashing the whole
        history on the hot thread)."""
        return digest_chain(tokens, self._block_size, base=base)

    # -------------------------------------------------------------- lookup --
    def acquire(self, prompt, digests: Optional[List[bytes]] = None) -> PrefixHit:
        """Longest cached prefix of ``prompt``, with one reference taken on
        every matched block (release with :meth:`release`, or hand them to a
        sequence whose flush decrefs). Matches shorter than
        ``min_prefix_blocks`` blocks come back empty. ``digests`` is the
        prompt's precomputed :meth:`chain`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.lookups += 1
        node = self._root
        matched: List[_Node] = []
        for digest in (digests if digests is not None else self.chain(prompt)):
            child = node.children.get(digest)
            if child is None:
                break
            if child.tier != "device" and not self._promote(child):
                # demoted node and no room to bring it back: the hit ends at
                # the deepest device-resident (or promotable) depth — a miss
                # at this depth, never a stall
                break
            matched.append(child)
            node = child
        if len(matched) < self._min_prefix_blocks:
            return PrefixHit([], 0)
        self._clock += 1
        for n in matched:
            n.last_touch = self._clock  # whole path stays warm
        blocks = [n.block for n in matched]
        self._kv.incref(blocks)
        return PrefixHit(blocks, len(blocks) * self._block_size)

    def _promote(self, node: _Node) -> bool:
        """Bring a demoted node's block back onto the device (store read →
        ``scatter_blocks``). Failure (device pool full, store entry gone)
        leaves the node demoted and its payload intact — the caller treats
        that depth as a miss."""
        store = getattr(self._kv, "tiered_store", None)
        if store is None or node.handle is None:
            return False
        try:
            data, _tier = store.read(node.handle)
            new_blocks = self._kv.scatter_blocks(data)
        except Exception:
            self.promote_failures += 1
            return False
        store.drop(node.handle)
        node.block = int(new_blocks[0])
        node.handle = None
        node.tier = "device"
        self._device_nodes += 1
        self.tier_promotions += 1
        return True

    def record_hit(self, n_blocks: int, tokens: int) -> None:
        """Account a hit the scheduler actually *applied* (a degraded or
        failed application releases its blocks and records nothing, so
        ``stats()`` agrees exactly with the scheduler's own counters)."""
        self.hits += 1
        self.hit_blocks += n_blocks
        self.tokens_served += tokens

    def release(self, blocks) -> None:
        """Return references taken by :meth:`acquire` (decref)."""
        if len(blocks):
            self._kv.free(blocks)

    # ----------------------------------------------------- drafter mining --
    def lookup_continuation(self, tokens, k: int,
                            digests: Optional[List[bytes]] = None) -> np.ndarray:
        """Mine the trie for a continuation of ``tokens`` — the prompt-lookup
        drafter's trie leg (speculative decoding): walk the full-block digest
        chain to the deepest indexed node, then descend children whose stored
        token blocks extend the partial tail, returning up to ``k`` proposed
        next tokens. Read-only: takes no block references and leaves LRU
        clocks untouched (drafting a continuation is not evidence the prefix
        will be re-prefilled). Empty when the history diverges from every
        indexed path."""
        if k <= 0:
            return np.empty(0, np.int32)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self._block_size
        n_full = tokens.size // bs
        if digests is None or len(digests) < n_full:
            # extend (never trust a short prompt-only chain: the walk depth
            # and the partial tail below must agree)
            digests = self.chain(tokens, base=digests)
        node = self._root
        for digest in digests[:n_full]:
            child = node.children.get(digest)
            if child is None:
                return np.empty(0, np.int32)
            node = child
        rem = tokens[n_full * bs:]
        out: List[int] = []
        while len(out) < k:
            nxt = None
            for child in node.children.values():
                ct = child.tokens
                if ct is not None and rem.size < ct.size and \
                        np.array_equal(ct[:rem.size], rem):
                    nxt = child
                    break
            if nxt is None:
                break
            tail = nxt.tokens[rem.size:]
            out.extend(int(t) for t in tail[:k - len(out)])
            node, rem = nxt, np.empty(0, np.int32)
        return np.asarray(out, np.int32)

    # ------------------------------------------------------- fleet export --
    def digest_catalog(self, limit: int = 64) -> List[str]:
        """The trie's fleet-visible shape: up to ``limit`` node digests
        (truncated hex, recency-first) for the replica's probe doc. A chained
        digest pins the whole prefix up to its block, so the router needs no
        structure — membership of the request chain's i-th digest means this
        replica holds the first ``i+1`` blocks. Safe from probe threads (the
        index lock guards the snapshot; staleness is bounded by the probe
        TTL)."""
        with self._index_lock:
            nodes = list(self._by_digest.values())
        nodes.sort(key=lambda n: n.last_touch, reverse=True)
        return [n.digest.hex()[:DIGEST_HEX] for n in nodes[:max(0, limit)]]

    def export_nodes(self, digests: List[bytes]) -> Tuple[List[int], np.ndarray]:
        """Deepest indexed path along ``digests`` (full chained digests):
        returns ``(block_ids, tokens)`` covering the matched prefix — the
        peer-fetch donor's read. Takes NO block references: the caller must
        run on the scheduler thread (the replica routes the fetch through the
        scheduler's control queue) and frame the blocks before yielding it."""
        node = self._root
        blocks: List[int] = []
        tokens: List[np.ndarray] = []
        self._clock += 1
        for digest in digests:
            child = node.children.get(digest)
            if child is None or child.tier != "device":
                # a donor serves only device-resident KV — promoting on a
                # peer's behalf would charge this replica's pool for another
                # replica's miss
                break
            child.last_touch = self._clock  # a fetched path is a hot path
            blocks.append(child.block)
            tokens.append(child.tokens)
            node = child
        if not blocks:
            return [], np.empty(0, np.int32)
        return blocks, np.concatenate(tokens)

    # ------------------------------------------------------------- publish --
    def publish(self, tokens, block_ids, committed_tokens: int,
                digests: Optional[List[bytes]] = None) -> int:
        """Index a sequence's full blocks: ``tokens`` is the token history,
        ``block_ids`` its block table, ``committed_tokens`` how many leading
        positions hold KV computed from exactly those tokens (the scheduler
        caps it below ``seen_tokens`` when chunked decode committed discarded
        over-run tokens); ``digests`` is a precomputed :meth:`chain` prefix.
        Each *newly indexed* block gains one trie reference; blocks whose
        prefix is already indexed are left to the sequence's flush. Returns
        the number of blocks newly pinned."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        block_ids = np.atleast_1d(np.asarray(block_ids)).astype(np.int64)
        bs = self._block_size
        n_full = min(int(committed_tokens) // bs, int(block_ids.size),
                     tokens.size // bs)
        if n_full <= 0:
            return 0
        node = self._root
        added = 0
        path = {id(self._root)}  # the walk's spine must not be evicted under it
        self._clock += 1
        for i, digest in enumerate(self.chain(tokens[:n_full * bs], base=digests)):
            child = node.children.get(digest)
            if child is None:
                if not self._make_room(1, protect=path):
                    break  # cap reached and nothing evictable: stop indexing
                block = int(block_ids[i])
                self._kv.incref([block])
                child = _Node(digest, block, node,
                              tokens=np.array(tokens[i * bs:(i + 1) * bs],
                                              np.int32, copy=True))
                node.children[digest] = child
                with self._index_lock:
                    self._by_digest[digest] = child
                self._device_nodes += 1
                added += 1
            child.last_touch = self._clock
            node = child
            path.add(id(node))
        self.published_blocks += added
        return added

    # ------------------------------------------------------------- evict --
    @property
    def n_blocks(self) -> int:
        """Device blocks currently pinned by the trie (demoted nodes pin
        none — their payloads live in the tiered store)."""
        return self._device_nodes

    @property
    def offloaded_nodes(self) -> int:
        return len(self._by_digest) - self._device_nodes

    def _evictable_leaves(self, protect) -> List[_Node]:
        return [n for n in self._by_digest.values()
                if not n.children and id(n) not in protect
                and n.tier == "device"
                and self._kv.ref_count(n.block) == 1]

    def _demotable_nodes(self, protect) -> List[_Node]:
        """Nodes whose device block can be demoted: device-resident with only
        the trie's reference (freeing a block a live sequence still maps
        reclaims nothing). Interior nodes qualify — a demoted mid-path node
        promotes back when an acquire walks through it."""
        return [n for n in self._by_digest.values()
                if n.tier == "device" and id(n) not in protect
                and self._kv.ref_count(n.block) == 1]

    def demote(self, n_blocks: int = 1, protect=frozenset()) -> int:
        """Move up to ``n_blocks`` trie blocks off the device into the tiered
        store (coldest first), freeing their device blocks WITHOUT forgetting
        the cached KV — the scheduler's ``_evict_one`` and the brownout
        demote-before-shed stage prefer this over :meth:`evict`, which
        discards. Returns how many device blocks were freed."""
        store = getattr(self._kv, "tiered_store", None)
        if store is None:
            return 0
        nodes = self._demotable_nodes(protect)
        nodes.sort(key=lambda n: n.last_touch)
        demoted = 0
        for node in nodes[:max(0, n_blocks)]:
            data = self._kv.gather_blocks([node.block])
            node.handle = store.put(data)
            self._kv.free([node.block])
            node.block = -1
            node.tier = "host"
            self._device_nodes -= 1
            demoted += 1
        self.tier_demotions += demoted
        return demoted

    def evict(self, n_blocks: int = 1, protect=frozenset()) -> int:
        """Unpin up to ``n_blocks`` device blocks, LRU-first, restricted to
        leaves no live sequence shares (freeing a shared leaf reclaims no
        memory — those blocks return when their sequences flush) and outside
        ``protect`` (node ids a publish walk is standing on). Evicting a leaf
        can expose its parent; the scan repeats until satisfied or dry.
        Returns how many blocks were actually freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable_leaves(protect)
            if not leaves:
                break
            if n_blocks - freed == 1:
                # the common KV-pressure shape (evict(1) per needed block):
                # one O(n) min beats a full sort
                self._remove(min(leaves, key=lambda n: n.last_touch))
                freed += 1
                break
            leaves.sort(key=lambda n: n.last_touch)
            for leaf in leaves:
                self._remove(leaf)
                freed += 1
                if freed >= n_blocks:
                    break
        self.evictions += freed
        return freed

    def _remove(self, node: _Node) -> None:
        assert not node.children
        del node.parent.children[node.digest]
        with self._index_lock:
            del self._by_digest[node.digest]
        if node.tier == "device":
            self._kv.free([node.block])
            self._device_nodes -= 1
        elif node.handle is not None:
            store = getattr(self._kv, "tiered_store", None)
            if store is not None:
                store.drop(node.handle)

    def _make_room(self, n: int, protect=frozenset()) -> bool:
        """Ensure the trie can pin ``n`` more blocks under ``max_blocks``."""
        if self._max_blocks is None:
            return True
        over = self.n_blocks + n - self._max_blocks
        if over <= 0:
            return True
        return self.evict(over, protect=protect) >= over

    def clear(self) -> None:
        """Release every trie reference (scheduler shutdown): blocks shared
        with still-live sequences survive until those sequences flush."""
        store = getattr(self._kv, "tiered_store", None)
        for node in list(self._by_digest.values()):
            node.children.clear()
        for node in list(self._by_digest.values()):
            with self._index_lock:
                del self._by_digest[node.digest]
            if node.tier == "device":
                self._kv.free([node.block])
                self._device_nodes -= 1
            elif node.handle is not None and store is not None:
                store.drop(node.handle)
        self._root.children.clear()

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        lookups = self.lookups
        return {
            "lookups": lookups,
            "hits": self.hits,
            "hit_rate": (self.hits / lookups) if lookups else 0.0,
            "hit_blocks": self.hit_blocks,
            "tokens_served": self.tokens_served,
            "trie_blocks": self.n_blocks,
            "evictions": self.evictions,
            "published_blocks": self.published_blocks,
            "max_blocks": self._max_blocks,
            "offloaded_nodes": self.offloaded_nodes,
            "tier_demotions": self.tier_demotions,
            "tier_promotions": self.tier_promotions,
            "promote_failures": self.promote_failures,
        }
