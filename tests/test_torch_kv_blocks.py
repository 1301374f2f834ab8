"""The port's prefix-cache bookkeeping held against the JAX package's,
step by step, on the CPU (``dataplane/kv_blocks.py``,
``dataplane/spec_decode.py:RadixProposer``).

Pure host state: every test drives the JAX and the port objects with
the same operations from one seeded generator and compares what each
returns (match lengths, the page ids a path names, evicted page ids,
spill handles, refcounts, owner multisets, tier residency) after every
operation, beside the reference's own invariant sweeps:

* ``HostKVTier``: LRU under a byte budget, move semantics, refusal of a
  page over budget; the port's entries are torch tensors (bf16 too);
* ``RadixCache``: the 300-op refcount soup, and the soup across tiers
  with spilling evictions, tiered matches, rehydrates and tier-side LRU
  drops, ending with both tiers drained to zero;
* ``BlockPool`` with owner sets: the fork-sharing soup;
* ``PrefixStore.match_for_admission`` (the tail rule, the rehydrate
  callback), ``release`` and ``clear``;
* ``RadixProposer``: the same drafts as JAX's on the same trie.
"""

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import kv_blocks as jkv
from kubeflow_controller_tpu.dataplane import spec_decode as jspec
from kubeflow_controller_tpu_torch.dataplane import kv_blocks as tkv
from kubeflow_controller_tpu_torch.dataplane import spec_decode as tspec

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)


def _toks(seq):
    return [int(t) for t in seq]


def _blocks(path):
    return [n.block for n in path]


# -- HostKVTier ---------------------------------------------------------------

def _np_page(fill, nbytes=8):
    arr = np.full((1, 1, nbytes // 2, 1), fill, np.int8)
    return (arr, arr.copy(), None, None)


def _t_page(fill, nbytes=8, dtype=torch.int8):
    per = nbytes // 2 // torch.empty((), dtype=dtype).element_size()
    arr = torch.full((1, 1, per, 1), fill, dtype=dtype)
    return (arr, arr.clone(), None, None)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_host_tier_lru_budget_and_move_semantics(dtype):
    """The reference's LRU script through both tiers: the same handles,
    residency, drops and popped bytes; bf16 entries (which numpy cannot
    hold) behave as int8 ones."""
    tiers = (jkv.HostKVTier(3 * 8), tkv.HostKVTier(3 * 8))
    pages = (_np_page, lambda f: _t_page(f, dtype=dtype))
    h = [[t.put(mk(i)) for i in (1, 2, 3)] for t, mk in zip(tiers, pages)]
    assert h[0] == h[1]
    h1, h2, h3 = h[1]
    for t in tiers:
        assert t.resident_pages == 3
        t.touch(h1)                           # h2 is now the coldest
    assert tiers[0].put(_np_page(4)) == tiers[1].put(pages[1](4))
    h4 = h3 + 1
    for t in tiers:
        assert t.has(h1) and t.has(h3) and t.has(h4) and not t.has(h2)
        assert t.evicted_pages == 1
    got = tiers[1].pop(h3)
    assert float(got[0][0, 0, 0, 0]) == 3 and got[0].dtype == dtype
    assert int(tiers[0].pop(h3)[0][0, 0, 0, 0]) == 3
    for t in tiers:
        assert not t.has(h3) and t.pop(h3) is None
        assert t.resident_pages == 2
        assert float(t.get(h1)[0][0, 0, 0, 0]) == 1 and t.has(h1)
        t.discard(h1)
        t.discard(h4)
        assert t.resident_pages == 0 and t.resident_bytes == 0


def test_host_tier_refuses_oversized_page_and_zero_budget():
    for tier_cls, page in ((jkv.HostKVTier, _np_page), (tkv.HostKVTier, _t_page)):
        tier = tier_cls(8)
        assert tier.put(page(1, nbytes=32)) is None
        assert tier_cls(0).put(page(1)) is None
        assert tier.has(None) is False
        with pytest.raises(ValueError, match=">= 0"):
            tier_cls(-1)
    assert tkv.HostKVTier.payload_nbytes(_t_page(1, 8)) == 8
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tkv.HostKVTier(8, injector=object())


# -- RadixCache soups, the JAX trie and the port's side by side ----------------

def _fake_payload(node, torch_side):
    """One tiny page keyed by the node's page id (the reference's stand-in
    for a gathered page)."""
    if torch_side:
        page = torch.full((1, 1, 2, 1), node.block % 127, dtype=torch.int8)
        return (page, page.clone(), None, None)
    page = np.full((1, 1, 2, 1), node.block % 127, np.int8)
    return (page, page.copy(), None, None)


def _fake_spill(tier, torch_side, log):
    def spill(wave):
        keep = []
        for n in wave:
            h = tier.put(_fake_payload(n, torch_side))
            log.append((n.block, h))
            if h is None:
                keep.append(False)
                continue
            n.host_handle = h
            keep.append(True)
        return keep
    return spill


def _state(pool, trie, tier=None):
    """Every node's (key path, block, refs, handle), the refcounts and
    the tier's residency: the whole observable state of one side."""
    nodes = []
    stack = [((), c) for c in trie.root.children.values()]
    while stack:
        prefix, n = stack.pop()
        key = prefix + (n.key,)
        nodes.append((key, n.block, n.refs, n.host_handle, n.last_use))
        stack.extend((key, c) for c in n.children.values())
    refs = [pool.refcount(b) for b in range(pool.n_blocks)]
    res = None if tier is None else (tier.resident_pages, tier.resident_bytes,
                                     tier.evicted_pages)
    return sorted(nodes), refs, pool.free_blocks, res


def _sweep(pool, trie, tier=None):
    """The reference's invariant sweep: resident nodes hold refcount 1 +
    pins and alias no page; spilled nodes are pin-free, shadow no
    resident descendant, and each live tier entry is one node's."""
    seen, n_res, handles = set(), 0, []
    stack = list(trie.root.children.values())
    while stack:
        n = stack.pop()
        if n.block >= 0:
            assert n.host_handle is None and n.block not in seen
            seen.add(n.block)
            assert pool.refcount(n.block) == 1 + n.refs
            n_res += 1
        else:
            assert n.refs == 0 and n.host_handle is not None
            if tier.has(n.host_handle):
                handles.append(n.host_handle)
            assert all(c.block < 0 for c in n.children.values())
        stack.extend(n.children.values())
    assert pool.used_blocks == n_res
    if tier is not None:
        assert len(handles) == len(set(handles))
        assert tier.resident_pages == len(handles)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trie_random_ops_equal_jax(seed):
    """The reference's 300-op soup (inserts, pins, releases, evictions,
    matches) through both tries: every call returns the same thing and
    leaves the same state, and the refcount invariant holds."""
    rng = np.random.default_rng(seed)
    sides = []
    for mod in (jkv, tkv):
        pool = mod.BlockPool(12)
        sides.append((pool, mod.RadixCache(pool, block_size=2), []))
    for _ in range(300):
        op = int(rng.integers(0, 4))
        toks = _toks(rng.integers(0, 4, size=int(rng.integers(2, 9))))
        pin = bool(rng.integers(0, 2))
        pick = int(rng.integers(0, 1 << 30))
        outs = []
        for pool, trie, held in sides:
            if op == 0:
                path, new = trie.insert(toks)
                if path and pin:
                    trie.acquire(path)
                    held.append(path)
                outs.append((_blocks(path), [(n.block, o) for n, o in new]))
            elif op == 1 and held:
                path = held.pop(pick % len(held))
                trie.release(path)
                outs.append(_blocks(path))
            elif op == 2:
                outs.append(trie.evict_one())
            else:
                outs.append(_blocks(trie.match(toks)))
            _sweep(pool, trie)
        assert outs[0] == outs[1]
        assert _state(*sides[0][:2]) == _state(*sides[1][:2])
    for pool, trie, held in sides:
        for path in held:
            trie.release(path)
        while trie.evict_one() is not None:
            pass
        assert pool.used_blocks == 0


def test_trie_random_ops_across_tiers_equal_jax():
    """The reference's tiered soup (its seed and its draws: spilling
    single and batch evictions, tiered matches, rehydrates) against a
    tier of ~6 pages, so tier-side LRU drops happen: the same evicted
    ids, spill handles, matches and state on both sides after every op,
    the reference's invariant sweep on both; at the end both tiers drain
    to zero."""
    rng = np.random.default_rng(0)
    sides = []
    for mod, torch_side in ((jkv, False), (tkv, True)):
        pool = mod.BlockPool(12)
        tier = mod.HostKVTier(6 * 4)
        trie = mod.RadixCache(pool, block_size=2, tier=tier)
        log = []
        sides.append(dict(pool=pool, tier=tier, trie=trie, held=[], log=log,
                          spill=_fake_spill(tier, torch_side, log)))

    def alloc(s):
        bid = s["pool"].alloc()
        while bid is None:
            if s["trie"].evict_one(spill=s["spill"]) is None:
                return None
            bid = s["pool"].alloc()
        return bid

    def rehydrate(s, path):
        trie, tier = s["trie"], s["tier"]
        got = []
        for n in [m for m in path if m.block < 0]:
            payload = tier.pop(n.host_handle)
            if payload is None:
                trie.prune_subtree(n)
                break
            bid = alloc(s)
            if bid is None:
                h = tier.put(payload)
                if h is None:
                    trie.prune_subtree(n)
                else:
                    n.host_handle = h
                break
            trie.rehydrated(n, bid)
            got.append((bid, int(payload[0][0, 0, 0, 0])))
        return got

    for _ in range(300):
        op = rng.integers(0, 6)
        if op == 0:
            toks = _toks(rng.integers(0, 4, size=rng.integers(2, 9)))
            res = [s["trie"].insert(toks) for s in sides]
            outs = [(_blocks(p), [(n.block, o) for n, o in new])
                    for p, new in res]
            if res[0][0] and rng.integers(0, 2):
                for s, (path, _) in zip(sides, res):
                    s["trie"].acquire(path)
                    s["held"].append(path)
        elif op == 1 and sides[0]["held"]:
            j = rng.integers(0, len(sides[0]["held"]))
            outs = []
            for s in sides:
                path = s["held"].pop(j)
                s["trie"].release(path)
                outs.append(_blocks(path))
        elif op == 2:
            outs = [s["trie"].evict_one(spill=s["spill"]) for s in sides]
        elif op == 3:
            k = int(rng.integers(1, 5))
            outs = [s["trie"].evict_chain(k, spill=s["spill"]) for s in sides]
        elif op == 4:
            toks = _toks(rng.integers(0, 4, size=rng.integers(2, 9)))
            outs = [_blocks(s["trie"].match_tiered(toks)) for s in sides]
        else:
            toks = _toks(rng.integers(0, 4, size=rng.integers(2, 9)))
            outs = [rehydrate(s, s["trie"].match_tiered(toks)) for s in sides]
        assert outs[0] == outs[1]
        assert sides[0]["log"] == sides[1]["log"]
        for s in sides:
            _sweep(s["pool"], s["trie"], s["tier"])
        assert (_state(sides[0]["pool"], sides[0]["trie"], sides[0]["tier"])
                == _state(sides[1]["pool"], sides[1]["trie"], sides[1]["tier"]))
    assert any(h is not None for _, h in sides[1]["log"])
    assert sides[1]["tier"].evicted_pages > 0
    for s in sides:
        for path in s["held"]:
            s["trie"].release(path)
        while s["trie"].evict_chain(s["pool"].used_blocks or 1, spill=s["spill"]):
            pass
        for child in list(s["trie"].root.children.values()):
            s["trie"].prune_subtree(child)
        assert s["pool"].used_blocks == 0
        assert s["tier"].resident_pages == 0 and s["tier"].resident_bytes == 0


def test_fork_refcount_soup_owner_ledger_equal_jax():
    """The reference's fork-ownership soup (slot tenancies, fork shares,
    fork and slot retirement, trie inserts, pins and evictions) against
    both pools with owner sets on: each page's refcount equals its owner
    multiset after every op, on both sides alike, and the soup drains to
    zero."""
    rng = np.random.default_rng(7)
    sides = []
    for mod in (jkv, tkv):
        pool = mod.BlockPool(24, debug_owners=True)
        sides.append(dict(pool=pool, trie=mod.RadixCache(pool, block_size=2),
                          slots={}, forks=[], held=[]))
    next_rid, next_g = 0, 0
    for step in range(300):
        op = int(rng.integers(0, 6))
        draws = [int(x) for x in rng.integers(0, 1 << 30, 4)]
        toks = _toks(rng.integers(0, 4, size=int(rng.integers(2, 7))))
        rid, g = next_rid, next_g
        for s in sides:
            pool, slots, forks = s["pool"], s["slots"], s["forks"]
            if op == 0 and pool.free_blocks > 2:
                slots[rid] = [pool.alloc(owner=("slot", rid))
                              for _ in range(1 + draws[0] % 2)]
            elif op == 1 and slots:
                prid = list(slots)[draws[0] % len(slots)]
                share = ([b for j, b in enumerate(slots[prid])
                          if (draws[1] >> j) & 1] or slots[prid][:1])
                for b in share:
                    pool.ref(b, owner=("fork", prid, g))
                forks.append((prid, g, share))
            elif op == 2 and forks:
                frid, fg, share = forks.pop(draws[0] % len(forks))
                for b in share:
                    pool.unref(b, owner=("fork", frid, fg))
            elif op == 3 and slots:
                prid = list(slots)[draws[0] % len(slots)]
                for b in slots.pop(prid):
                    pool.unref(b, owner=("slot", prid))
            elif op == 4:
                if pool.free_blocks > 4:
                    path, _ = s["trie"].insert(toks)
                    if path and draws[2] & 1:
                        s["trie"].acquire(path)
                        s["held"].append(path)
                elif s["held"]:
                    s["trie"].release(s["held"].pop())
            else:
                s["trie"].evict_one()
            for bid in range(24):
                assert pool.refcount(bid) == sum(pool.owners(bid).values())
        next_rid += op == 0
        next_g += op == 1
        assert ([(sides[0]["pool"].refcount(b), sides[0]["pool"].owners(b))
                 for b in range(24)]
                == [(sides[1]["pool"].refcount(b), sides[1]["pool"].owners(b))
                    for b in range(24)])
        assert sides[0]["slots"] == sides[1]["slots"]
        assert sides[0]["forks"] == sides[1]["forks"]
    for s in sides:
        pool = s["pool"]
        for frid, fg, share in s["forks"]:
            for b in share:
                pool.unref(b, owner=("fork", frid, fg))
        for prid, bids in s["slots"].items():
            for b in bids:
                pool.unref(b, owner=("slot", prid))
        for path in s["held"]:
            s["trie"].release(path)
        while s["trie"].evict_one() is not None:
            pass
        assert pool.used_blocks == 0
        with pytest.raises(RuntimeError, match="non-owner|double free"):
            b = pool.alloc(owner=("slot", 1))
            pool.unref(b, owner=("slot", 2))


# -- PrefixStore ----------------------------------------------------------------

def test_prefix_store_admission_tail_rehydrate_release_clear():
    """``match_for_admission`` on both sides: the tail rule (a fully
    cached prompt still prefills its last block), the resident head
    pinned before the rehydrate callback runs, the callback's restored
    count; ``release`` and ``clear`` return every page and tier entry."""
    bs = 2
    stores, calls = [], []
    for mod, torch_side in ((jkv, False), (tkv, True)):
        tier = mod.HostKVTier(1 << 20)
        store = mod.PrefixStore(None, bs, 10, tier=tier)
        log = []
        spill = _fake_spill(tier, torch_side, log)
        seen = []

        def rehydrate(nodes, store=store, seen=seen):
            # The resident head is pinned before this runs.
            seen.append([n.refs for n in _path_of(store, nodes[0])])
            restored = 0
            for n in nodes[:2]:                # restore at most two
                payload = store.tier.pop(n.host_handle)
                bid = store.pool.alloc()
                store.trie.rehydrated(n, bid)
                store.trie.acquire([n])
                restored += 1 if payload is not None else 0
            return restored

        stores.append((store, spill, rehydrate))
        calls.append(seen)
    prompt = list(range(10))
    outs = []
    for store, spill, rehydrate in stores:
        path, _ = store.trie.insert(prompt)              # 5 full blocks
        got = [len(path)]
        p1, m1 = store.match_for_admission(prompt)       # tail rule: 4
        got.append((len(p1), m1))
        store.release(p1)
        p2, m2 = store.match_for_admission(prompt + [99])  # all 5
        got.append((len(p2), m2))
        store.release(p2)
        got.append(store.trie.evict_chain(3, spill=spill))   # spill 3 leaves
        p3, m3 = store.match_for_admission(prompt + [99], rehydrate=rehydrate)
        got.append((_blocks(p3), m3))
        got.append([n.refs for n in p3])
        store.release(p3)
        got.append(store.tier.resident_pages)
        store.clear()
        got.append((store.pool.used_blocks, store.tier.resident_pages,
                    store.trie.n_nodes()))
        outs.append(got)
    assert outs[0] == outs[1]
    assert calls[0] == calls[1] == [[1, 1]]
    assert outs[1][2] == (5, 10) and outs[1][1] == (4, 8)
    assert outs[1][-1] == (0, 0, 0)


def _path_of(store, node):
    """The resident ancestors of ``node``, root-exclusive."""
    out = []
    n = node.parent
    while n is not None and n is not store.trie.root:
        out.append(n)
        n = n.parent
    return out[::-1]


# -- RadixProposer ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_radix_drafts_equal_jax(seed):
    """Both proposers over tries grown by the same inserts and matches
    (so ``last_use`` orders children alike): the same drafts and lengths
    for contexts that walk, stop mid-block, diverge or miss, and the walk
    changes nothing in the trie."""
    rng = np.random.default_rng(seed)
    bs = 4
    tries = []
    for mod in (jkv, tkv):
        store = mod.PrefixStore(None, bs, 64)
        tries.append(store)
    seqs = [_toks(rng.integers(0, 5, size=int(rng.integers(4, 24))))
            for _ in range(12)]
    for seq in seqs:
        for store in tries:
            store.trie.insert(seq)
            store.trie.match(seq[:8])
    props = (jspec.make_proposer("radix", tries[0]),
             tspec.make_proposer("radix", tries[1]))
    assert isinstance(props[1], tspec.RadixProposer)
    ctxs = []
    for seq in seqs:
        cut = int(rng.integers(1, len(seq) + 1))
        ctxs.append(np.asarray(seq[:cut], np.int32))
        ctxs.append(np.asarray(seq[:cut] + [int(rng.integers(0, 5))], np.int32))
    ctxs.append(None)
    before = _state(tries[1].pool, tries[1].trie)
    for k in (1, 3, 4, 9):
        dj, lj = props[0].propose(ctxs, k)
        dt, lt = props[1].propose(ctxs, k)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
        assert lt.max() > 0
    assert _state(tries[1].pool, tries[1].trie) == before
    for c in ctxs:
        if c is not None:
            assert props[1].has_candidate(c) == props[0].has_candidate(c)
