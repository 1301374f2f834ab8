"""KV page accounting: the block pool, the radix prefix trie and the
host tier beneath it.

Counterpart of ``kubeflow_controller_tpu/dataplane/kv_blocks.py``. Every
slot's KV lives in fixed ``block_size``-token pages of one device pool
``[L, n_blocks, block_size, KVH, D]`` (``models/generate.py:
PagedKVCache``); this module is the pure-host bookkeeping over it:

* :class:`BlockPool`: a free-list allocator with refcounts (and owner
  sets for copy-on-write forks);
* :class:`RadixCache` (SGLang's RadixAttention): a trie over
  block-granular token chunks whose nodes name pool pages. Admission
  appends a matched chain's page ids to the slot's block table (no bytes
  move); finished prefills and retirements publish their own pages into
  the trie (:meth:`RadixCache.insert_owned`, ownership moves, no copy);
  eviction is LRU over unpinned effective leaves;
* :class:`HostKVTier`: a byte-budgeted host LRU beneath the trie. An
  evicted node's page bytes spill there (the node stays, SPILLED:
  ``block == -1``, ``host_handle`` set) and a later admission walking
  into it installs them back, bytes verbatim;
* :class:`PrefixStore`: the trie and the allocator, the unit the engine
  owns.

Ownership: every pool page is owned by one live slot (refcount 1), held
by a trie node (refcount 1 for the trie, plus one pin per live request
whose table names it), or fork-shared (one direct ref per ``n > 1``
child, never published by the child). Every retirement path releases
through one funnel, and a page's refcount reaches zero once a tenancy
(:meth:`BlockPool.unref` raises on a second). The trie's decisions (which
node matches, which is evicted, which handle a spill gets) are the JAX
package's, step for step.
"""

from __future__ import annotations

import heapq
import os
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def kv_bytes_per_token(cfg, kv_quant: str = "", tp: int = 1) -> int:
    """Device bytes one token's K+V occupies across all layers, per
    device.

    fp pages: ``2 * L * KVH * D * itemsize``. int8 pages add an fp32
    scale per (token row, head, layer, k/v): ``2 * L * KVH * (D + 4)``.
    ``tp`` > 1 shards the KVH axis, so per-device bytes drop by ``tp``.
    """
    if tp < 1 or cfg.n_kv_heads % tp:
        raise ValueError(
            f"kv_bytes_per_token: n_kv_heads={cfg.n_kv_heads} not "
            f"divisible by tp={tp}"
        )
    if kv_quant == "int8":
        per_head = cfg.head_dim * 1 + 4
    elif not kv_quant or kv_quant == "none":
        per_head = cfg.head_dim * torch.empty((), dtype=cfg.dtype).element_size()
    else:
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return 2 * cfg.n_layers * (cfg.n_kv_heads // tp) * per_head


def blocks_for_budget(
    cfg, block_size: int, budget_bytes: int, kv_quant: str = "",
    tp: int = 1,
) -> int:
    """How many KV pages fit in ``budget_bytes`` of per-device memory.
    One page holds k AND v for ``block_size`` tokens across all layers;
    int8 pages account their fp32 dequant scales too."""
    per_block = block_size * kv_bytes_per_token(cfg, kv_quant, tp)
    return max(0, int(budget_bytes) // per_block)


#: Anonymous owner token: plain alloc/ref/unref calls (slot ownership,
#: trie holds, request pins) account under this label, so the debug owner sets cost those call
#: sites nothing.
_ANON_OWNER = "<anon>"


class BlockPool:
    """Free-list allocator over ``n_blocks`` page ids with refcounts.

    Pure host state — no device tensors. ``alloc`` hands out a page at
    refcount 1; ``ref``/``unref`` adjust pins; the unref that reaches
    zero returns the page to the free list. Double-free (unref past
    zero, or unref of a never-allocated page) raises — an allocator that
    silently recycled an aliased page would corrupt KV undetectably.

    **Owner-set debug mode** (``debug_owners=True`` or env
    ``TPUJOB_KV_DEBUG_OWNERS=1``): every ref carries an owner token
    (copy-on-write forks tag theirs ``("fork", rid, gen)``; everything
    else accounts under an anonymous label), and a release whose owner
    holds no reference raises at once instead of corrupting a
    neighbour's refcount — the class of bug forking makes possible (two
    slots' table rows naming one physical page) and that a bare refcount
    cannot catch. Off by default.
    """

    def __init__(self, n_blocks: int, debug_owners: Optional[bool] = None):
        if n_blocks < 0:
            raise ValueError(f"n_blocks must be >= 0 (got {n_blocks})")
        self.n_blocks = n_blocks
        # LIFO free list: recently freed pages are reused first, which
        # keeps the working set of pool pages dense.
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._refs: List[int] = [0] * n_blocks
        if debug_owners is None:
            debug_owners = os.environ.get(
                "TPUJOB_KV_DEBUG_OWNERS", "") not in ("", "0", "false")
        self.debug_owners = bool(debug_owners)
        # page id -> Counter of owner tokens (a multiset: one owner may
        # hold several pins).
        self._owners: Dict[int, Counter] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def owners(self, bid: int) -> Counter:
        """The page's live owner multiset (empty unless debug mode)."""
        return Counter(self._owners.get(bid, Counter()))

    def alloc(self, owner: object = None) -> Optional[int]:
        """Pop a free page at refcount 1, or None when exhausted."""
        if not self._free:
            return None
        bid = self._free.pop()
        if self._refs[bid] != 0:
            raise RuntimeError(f"free-list page {bid} had refs")
        self._refs[bid] = 1
        if self.debug_owners:
            self._owners[bid] = Counter(
                [owner if owner is not None else _ANON_OWNER])
        return bid

    def ref(self, bid: int, owner: object = None) -> None:
        if self._refs[bid] <= 0:
            raise RuntimeError(f"ref of dead page {bid}")
        self._refs[bid] += 1
        if self.debug_owners:
            self._owners[bid][
                owner if owner is not None else _ANON_OWNER] += 1

    def unref(self, bid: int, owner: object = None) -> None:
        if self._refs[bid] <= 0:
            raise RuntimeError(f"double free of page {bid}")
        if self.debug_owners:
            token = owner if owner is not None else _ANON_OWNER
            held = self._owners.get(bid, Counter())
            if held[token] <= 0:
                raise RuntimeError(
                    f"release of page {bid} by non-owner {token!r} "
                    f"(held by {sorted(map(repr, held.elements()))})")
            held[token] -= 1
            if held[token] <= 0:
                del held[token]
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._free.append(bid)
            self._owners.pop(bid, None)


class HostKVTier:
    """Byte-budgeted host-memory LRU of spilled KV pages.

    Each entry is one pool page's bytes as ``(k, v, k_scale, v_scale)``
    tensors ``[L, 1, block_size, KVH(, D)]`` in the pool's storage types
    (scales None for fp pools; pinned when the pool is on the card), as
    ``models/generate.py:gather_pool_pages`` returns them and
    ``install_pool_pages`` takes them back (joined along dim 1): the
    round trip moves bytes
    verbatim and never requantizes, so streams stay bit-identical.

    ``put`` LRU-evicts entries until the page fits and returns ``None``
    when a single page exceeds the whole budget (the caller then
    discards the page). Handles are never reused: a handle whose entry
    was dropped stops answering :meth:`has`, and the trie prunes its
    node on the next walk through it.

    ``injector`` (fault injection, ``dataplane/faults.py``): an injected
    ``tier_io_error`` at the ``tier.read`` site makes a read behave
    exactly like a page lost to LRU pressure: ``has()`` answers False
    and ``pop()`` drops the entry and returns None, so every caller
    degrades through the discard path a dead handle already takes (the
    trie prunes the spilled subtree and admission prefills those tokens
    again). ``injector`` and ``target`` (the replica name specs match)
    are plain attributes: the owning engine learns its name after it is
    built.

    ``shards``: an engine over a tp mesh of that many ranks, each rank's
    tier holding its own ``1 / shards`` of every page's heads. The budget
    and the residency count whole pages' bytes (``shards`` times an
    entry's), as the JAX package's tier of whole pages does, so that
    every rank spills, evicts and refuses the same pages at any tp.
    """

    def __init__(self, budget_bytes: int, injector=None, target: str = "",
                 shards: int = 1):
        if budget_bytes < 0:
            raise ValueError(
                f"budget_bytes must be >= 0 (got {budget_bytes})")
        self.budget_bytes = int(budget_bytes)
        self.shards = int(shards)
        self._pages: "OrderedDict[int, tuple]" = OrderedDict()
        self._nbytes: Dict[int, int] = {}
        self._next_handle = 0
        self.resident_bytes = 0
        #: entries dropped by LRU budget pressure (their trie nodes go
        #: stale and are pruned on the next tiered walk).
        self.evicted_pages = 0
        self.injector = injector
        self.target = target
        #: injected read failures absorbed (0 outside fault runs).
        self.io_errors = 0

    @property
    def resident_pages(self) -> int:
        return len(self._pages)

    def _read_fault(self) -> bool:
        inj = self.injector
        if inj is None:
            return False
        spec = inj.fires("tier", "tier.read", target=self.target,
                         kinds=("tier_io_error",))
        if spec is None:
            return False
        self.io_errors += 1
        return True

    @staticmethod
    def payload_nbytes(payload: tuple) -> int:
        return sum(int(a.nbytes) for a in payload if a is not None)

    def page_nbytes(self, payload: tuple) -> int:
        """The whole page's bytes of this rank's ``payload``."""
        return self.payload_nbytes(payload) * self.shards

    def put(self, payload: tuple) -> Optional[int]:
        """Admit one page's bytes, LRU-evicting until it fits. Returns
        the handle, or ``None`` when the page alone exceeds the budget
        (budget 0 admits nothing)."""
        nbytes = self.page_nbytes(payload)
        if nbytes > self.budget_bytes:
            return None
        while self.resident_bytes + nbytes > self.budget_bytes:
            h, _ = self._pages.popitem(last=False)
            self.resident_bytes -= self._nbytes.pop(h)
            self.evicted_pages += 1
        h = self._next_handle
        self._next_handle += 1
        self._pages[h] = payload
        self._nbytes[h] = nbytes
        self.resident_bytes += nbytes
        return h

    def has(self, handle: Optional[int]) -> bool:
        if handle is None or handle not in self._pages:
            return False
        return not self._read_fault()

    def touch(self, handle: int) -> None:
        self._pages.move_to_end(handle)

    def get(self, handle: int) -> tuple:
        """Peek (and LRU-touch) a resident entry without moving it."""
        payload = self._pages[handle]
        self._pages.move_to_end(handle)
        return payload

    def pop(self, handle: Optional[int]) -> Optional[tuple]:
        """Remove and return an entry (None if dead): the rehydrate path.
        After a pop the bytes live in one place only, so no page is ever
        aliased across tiers."""
        if handle is None or handle not in self._pages:
            return None
        payload = self._pages.pop(handle)
        self.resident_bytes -= self._nbytes.pop(handle)
        if self._read_fault():
            # The bytes failed to read back: the entry is gone (no leak)
            # and the caller sees a dead handle.
            return None
        return payload

    def discard(self, handle: Optional[int]) -> None:
        self.pop(handle)


@dataclass(eq=False)
class RadixNode:
    """One trie edge: one full block of ``block_size`` token ids.

    ``refs`` counts live-request pins (the trie's own hold on the pool
    page is in the :class:`BlockPool` refcount). A SPILLED node
    (``block == -1``, ``host_handle`` set) keeps its key but holds no
    pool page and takes no pins."""

    key: Tuple[int, ...]
    block: int
    parent: Optional["RadixNode"]
    children: Dict[Tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    refs: int = 0
    last_use: int = 0
    host_handle: Optional[int] = None


class RadixCache:
    """Radix trie over block-granular token chunks.

    Every node below the root names one pool page holding the KV of its
    ``block_size`` tokens in the context of its ancestors, so a match is
    an exact prefix by construction. Eviction is LRU over unpinned
    effective leaves (a node whose children are all spilled counts);
    interior nodes become evictable once their resident subtree is gone.

    Candidates live in a lazy-deletion min-heap keyed by ``last_use``:
    pushed when they become candidates (creation, last pin released,
    last resident child evicted or spilled) and validated at pop time.
    ``_touch`` makes ``last_use`` unique, so the victim order is the full
    rescan's. With a :class:`HostKVTier`, ``evict_chain`` hands each
    victim wave to a spill callback before the pages are freed; victims
    it keeps become SPILLED nodes.
    """

    def __init__(self, pool: BlockPool, block_size: int,
                 tier: Optional[HostKVTier] = None):
        if block_size <= 0:
            raise ValueError(f"block_size must be > 0 (got {block_size})")
        self.pool = pool
        self.block_size = block_size
        self.tier = tier
        self.root = RadixNode(key=(), block=-1, parent=None)
        self._tick = 0
        # (last_use at push, seq, node): seq breaks ties without ever
        # comparing nodes.
        self._heap: List[Tuple[int, int, RadixNode]] = []
        self._heap_seq = 0

    # -- internals -------------------------------------------------------

    def _touch(self, node: RadixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def _push_evictable(self, node: RadixNode) -> None:
        """Register an eviction candidate (duplicates are harmless:
        pop-time validation drops them)."""
        if node is self.root:
            return
        self._heap_seq += 1
        heapq.heappush(self._heap, (node.last_use, self._heap_seq, node))

    def _blocked_by_children(self, node: RadixNode) -> bool:
        """A resident child blocks eviction; a spilled one does not."""
        return any(c.block >= 0 for c in node.children.values())

    def _pop_evictable(self) -> Optional[RadixNode]:
        """Pop the least-recently-used valid candidate. Tombstoned and
        spilled entries drop; entries touched since their push re-push
        with the current stamp; pinned nodes and nodes with a resident
        child drop (re-pushed on the transition that frees them); nodes
        whose only bar is an outside pool ref (a live table reads the
        page) go back on the heap, since the trie cannot see that ref
        go."""
        deferred: List[Tuple[int, int, RadixNode]] = []
        found: Optional[RadixNode] = None
        while self._heap:
            pushed, seq, node = heapq.heappop(self._heap)
            if node.parent is None or node.block < 0:
                continue
            if pushed != node.last_use:
                self._push_evictable(node)
                continue
            if node.refs > 0 or self._blocked_by_children(node):
                continue
            if self.pool.refcount(node.block) > 1:
                deferred.append((pushed, seq, node))
                continue
            found = node
            break
        for entry in deferred:
            heapq.heappush(self._heap, entry)
        return found

    def _drop_victim(self, node: RadixNode) -> None:
        """Unlink an eviction victim, discarding its (all-spilled)
        subtree's host bytes, and re-rank the parent."""
        parent = node.parent
        del parent.children[node.key]
        node.parent = None                    # tombstone for heap entries
        self._discard_handles(node)
        if parent is not self.root and not self._blocked_by_children(parent):
            self._push_evictable(parent)

    def _discard_handles(self, node: RadixNode) -> None:
        """Drop every host entry in ``node``'s subtree: spilled
        descendants of a dropped node lost their context."""
        stack = [node]
        while stack:
            n = stack.pop()
            if self.tier is not None and n.host_handle is not None:
                self.tier.discard(n.host_handle)
            n.host_handle = None
            stack.extend(n.children.values())

    def evict_chain(self, k: int, spill=None) -> List[int]:
        """Free up to ``k`` pool pages from the LRU end of the trie and
        return their ids (fewer when the trie runs out of victims), in
        the order of ``k`` single evictions: a parent whose last resident
        child enters the wave joins the same wave.

        ``spill(nodes) -> List[bool]`` runs once per wave BEFORE any page
        is freed (the pages still hold their bytes); nodes it keeps
        become SPILLED (key kept, page freed), the rest are dropped.
        ``spill=None`` discards."""
        freed: List[int] = []
        while len(freed) < k:
            wave: List[RadixNode] = []
            wave_blocks: List[int] = []
            while len(freed) + len(wave) < k:
                node = self._pop_evictable()
                if node is None:
                    break
                wave.append(node)
                # Mark the node spilled for the moment, so that its
                # parent counts as unblocked and may join this wave; the
                # real disposition is settled after the callback.
                wave_blocks.append(node.block)
                node.block = -1
                parent = node.parent
                if (parent is not self.root
                        and not self._blocked_by_children(parent)):
                    self._push_evictable(parent)
            for node, bid in zip(wave, wave_blocks):
                node.block = bid
            if not wave:
                break
            keep = spill(wave) if spill is not None else [False] * len(wave)
            for node, kept in zip(wave, keep):
                bid = node.block
                if kept:
                    node.block = -1           # SPILLED: key and handle stay
                else:
                    self._drop_victim(node)   # block keeps the stale id
                self.pool.unref(bid)          # the trie's hold
                freed.append(bid)
        return freed

    def evict_one(self, spill=None) -> Optional[int]:
        """Drop (or spill) the LRU unpinned effective leaf; its freed
        page id, or None when nothing is evictable."""
        freed = self.evict_chain(1, spill=spill)
        return freed[0] if freed else None

    # -- queries ---------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Longest chain of RESIDENT full blocks prefixing ``tokens``
        (root-exclusive, possibly empty); stops at a spilled node."""
        bs = self.block_size
        path: List[RadixNode] = []
        node = self.root
        toks = [int(t) for t in tokens]
        for i in range(0, len(toks) - bs + 1, bs):
            child = node.children.get(tuple(toks[i:i + bs]))
            if child is None or child.block < 0:
                break
            self._touch(child)
            path.append(child)
            node = child
        return path

    def match_tiered(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Longest cached chain across both tiers: resident nodes, then
        any run of spilled nodes whose host bytes are live. A spilled
        node whose entry was dropped is pruned here with its subtree and
        ends the walk. No resident node sits below a spilled one, so the
        path is ``resident* spilled*``."""
        bs = self.block_size
        path: List[RadixNode] = []
        node = self.root
        toks = [int(t) for t in tokens]
        for i in range(0, len(toks) - bs + 1, bs):
            child = node.children.get(tuple(toks[i:i + bs]))
            if child is None:
                break
            if child.block < 0:
                if self.tier is None or not self.tier.has(child.host_handle):
                    self.prune_subtree(child)
                    break
                self.tier.touch(child.host_handle)
            self._touch(child)
            path.append(child)
            node = child
        return path

    def prune_subtree(self, node: RadixNode) -> None:
        """Unlink a dead spilled node and its (spilled, pin-free)
        subtree, discarding the subtree's surviving host entries."""
        stack = [node]
        while stack:
            m = stack.pop()
            if m.block >= 0 or m.refs:
                raise RuntimeError(
                    "prune_subtree: resident or pinned node below a "
                    "spilled one")
            stack.extend(m.children.values())
        del node.parent.children[node.key]
        node.parent = None
        self._discard_handles(node)

    def insert(
        self, tokens: Sequence[int],
        known_path: Sequence[RadixNode] = (),
    ) -> Tuple[List[RadixNode], List[Tuple[RadixNode, int]]]:
        """Ensure every full block of ``tokens`` has a resident node,
        ALLOCATING pages (evicting if need be) for blocks not yet there:
        the external ingest (``register_prefix``). Returns ``(path,
        new)``; ``new`` lists ``(node, token_offset)`` whose KV the
        caller must write into the node's page. Best effort: with every
        page pinned the chain stops short. ``known_path``: a chain
        already matched and pinned for this prefix; the walk resumes
        after it."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        node = known_path[-1] if known_path else self.root
        path: List[RadixNode] = list(known_path)
        new: List[Tuple[RadixNode, int]] = []
        for i in range(len(known_path) * bs, len(toks) - bs + 1, bs):
            key = tuple(toks[i:i + bs])
            child = node.children.get(key)
            if child is None or child.block < 0:
                bid = self.pool.alloc()
                while bid is None:
                    if self.evict_one() is None:
                        return path, new          # pool fully pinned
                    bid = self.pool.alloc()
                if child is None:
                    child = RadixNode(key=key, block=bid, parent=node)
                    node.children[key] = child
                else:
                    # A spilled node: the caller writes this block's KV
                    # anyway, so the host copy goes.
                    child.block = bid
                    if self.tier is not None:
                        self.tier.discard(child.host_handle)
                    child.host_handle = None
                new.append((child, i))
                self._push_evictable(child)
            self._touch(child)
            path.append(child)
            node = child
        return path, new

    def insert_owned(
        self, tokens: Sequence[int], owned: Dict[int, int],
        known_path: Sequence[RadixNode] = (),
    ) -> Tuple[List[RadixNode], List[int]]:
        """Publish a slot's own in-pool blocks: ``owned`` maps token
        offsets (multiples of ``block_size``) to the page holding that
        block, owned by the slot at refcount 1. A block the trie lacks
        (or holds spilled) ADOPTS the page: the slot's ref becomes the
        trie's hold, no copy. A block another slot published first keeps
        its node, and the caller's duplicate stays owned by the caller.
        Returns ``(path, adopted_offsets)``: the caller stops tracking
        the adopted pages and acquires the path extension it keeps
        reading. Stops early at an offset missing from ``owned``."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        node = known_path[-1] if known_path else self.root
        path: List[RadixNode] = list(known_path)
        adopted: List[int] = []
        for i in range(len(known_path) * bs, len(toks) - bs + 1, bs):
            key = tuple(toks[i:i + bs])
            child = node.children.get(key)
            if child is None or child.block < 0:
                bid = owned.get(i)
                if bid is None:
                    return path, adopted
                if child is None:
                    child = RadixNode(key=key, block=bid, parent=node)
                    node.children[key] = child
                else:
                    # Spilled, and the publisher's page holds the same
                    # bytes: the device copy wins, the host one goes.
                    child.block = bid
                    if self.tier is not None:
                        self.tier.discard(child.host_handle)
                    child.host_handle = None
                adopted.append(i)
                self._push_evictable(child)
            self._touch(child)
            path.append(child)
            node = child
        return path, adopted

    def rehydrated(self, node: RadixNode, bid: int) -> None:
        """Mark a spilled node resident on ``bid`` (the caller installed
        its bytes there and its refcount-1 ref becomes the trie's
        hold)."""
        if node.block >= 0 or node.parent is None:
            raise RuntimeError("rehydrated: node is not a live spilled node")
        node.block = bid
        node.host_handle = None
        self._touch(node)
        self._push_evictable(node)

    def acquire(self, path: Sequence[RadixNode]) -> None:
        """Pin a chain for a live request (one pin a node, on the node
        and its page). Resident nodes only."""
        for n in path:
            if n.block < 0:
                raise RuntimeError("acquire of spilled radix node")
            n.refs += 1
            self.pool.ref(n.block)

    def release(self, path: Sequence[RadixNode]) -> None:
        """Drop a live request's pins (every retirement path)."""
        for n in path:
            if n.refs <= 0:
                raise RuntimeError("release of unpinned radix node")
            n.refs -= 1
            self.pool.unref(n.block)
            if n.refs == 0:
                self._push_evictable(n)

    def n_nodes(self) -> int:
        count = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            count += 1
            stack.extend(n.children.values())
        return count


class PrefixStore:
    """The trie and its allocator: the unit the engine owns (sharing the
    engine's pool, so reservations and trie tenancy compete for the
    same pages; a fresh pool when none is given).

    ``match_for_admission`` leaves at least one prompt token to prefill:
    admission needs the last prompt position's logits, which only a
    prefill of >= 1 token produces."""

    def __init__(self, cfg, block_size: int, n_blocks: int,
                 pool: Optional[BlockPool] = None,
                 tier: Optional[HostKVTier] = None):
        self.cfg = cfg
        self.block_size = block_size
        self.pool = pool if pool is not None else BlockPool(n_blocks)
        self.tier = tier
        self.trie = RadixCache(self.pool, block_size, tier=tier)

    @property
    def n_blocks(self) -> int:
        return self.pool.n_blocks

    def match_for_admission(
        self, tokens: Sequence[int], rehydrate=None,
    ) -> Tuple[List[RadixNode], int]:
        """(pinned path, matched token count) for a prompt being
        admitted; the caller owns the release. With a tier and a
        ``rehydrate(spilled_nodes) -> restored`` callback the walk goes
        on through spilled nodes: the resident head is pinned FIRST (the
        callback's allocations may evict, and must not take the prefix
        the request is about to read), then the callback installs and
        pins the spilled run and returns how many it restored."""
        if self.tier is None or rehydrate is None:
            path = self.trie.match(tokens)
            while path and len(path) * self.block_size >= len(tokens):
                path.pop()                # leave >= 1 token to prefill
            self.trie.acquire(path)
            return path, len(path) * self.block_size
        path = self.trie.match_tiered(tokens)
        while path and len(path) * self.block_size >= len(tokens):
            path.pop()                    # leave >= 1 token to prefill
        split = next(
            (j for j, n in enumerate(path) if n.block < 0), len(path))
        resident, spilled = path[:split], path[split:]
        self.trie.acquire(resident)
        if spilled:
            restored = rehydrate(spilled)
            resident = resident + spilled[:restored]
        return resident, len(resident) * self.block_size

    def release(self, path: Sequence[RadixNode]) -> None:
        self.trie.release(path)

    def clear(self) -> None:
        """Drop every cached prefix (no request pin may be live): the
        trie's hold on each resident page goes back to the pool, spilled
        entries are discarded, and a fresh trie is built over a fresh
        tier."""
        stack = list(self.trie.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.refs:
                raise RuntimeError("clear() with live request pins")
            if n.block >= 0:
                self.pool.unref(n.block)
            elif self.tier is not None:
                self.tier.discard(n.host_handle)
        if self.tier is not None:
            self.tier = HostKVTier(self.tier.budget_bytes,
                                   injector=self.tier.injector,
                                   target=self.tier.target,
                                   shards=self.tier.shards)
        self.trie = RadixCache(self.pool, self.block_size, tier=self.tier)
