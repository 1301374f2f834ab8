"""KV page accounting and the block pool's free-list allocator.

Counterpart of ``kubeflow_controller_tpu/dataplane/kv_blocks.py``:
:func:`kv_bytes_per_token`, :func:`blocks_for_budget` and
:class:`BlockPool` (with the owner-tracked refcounts that copy-on-write
forks share pages under) only. Every slot's KV lives in fixed
``block_size``-token pages of one device pool ``[L, n_blocks,
block_size, KVH, D]`` (``models/generate.py:PagedKVCache``); this module
is the pure-host bookkeeping over it. The radix prefix trie and the
host tier are later slices of the port.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional

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


#: Anonymous owner token: plain alloc/ref/unref calls (slot ownership)
#: account under this label, so the debug owner sets cost those call
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
