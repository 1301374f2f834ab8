"""Model-free draft proposers for greedy speculative decoding.

Counterpart of ``kubeflow_controller_tpu/dataplane/spec_decode.py``
(host numpy code; the port keeps its own copy). Something cheap guesses
the next K tokens, one forward (``models/generate.py:
verify_step_paged``) scores all K+1 positions, and the longest accepted
run commits: the committed stream is the stream plain greedy decode
would have produced.

* :class:`PromptLookupProposer` — prompt lookup: match the last n-gram
  of the request's prompt + emitted tokens against its earlier history
  and propose the tokens that followed the most recent earlier
  occurrence;
* :class:`RadixProposer` — walk the prefix cache's trie with the context
  and propose a cached continuation.

Contract: ``propose(contexts, k)`` takes one optional 1-D int32 context
per slot (prompt + emitted tokens + the next committed token; None =
slot not drafting) and returns a padded ``[B, k]`` int32 draft array
plus per-row valid lengths ``[B]``. Proposals are deterministic
functions of the contexts, never longer than ``k``, and every proposed
token is copied from the context.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from kubeflow_controller_tpu_torch.dataplane.kv_blocks import (
    PrefixStore, RadixNode,
)


class DraftProposer:
    """Interface: batched, deterministic, model-free draft proposal."""

    def propose(
        self,
        contexts: Sequence[Optional[np.ndarray]],
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``contexts[b]`` is the slot's full token context (1-D int32:
        prompt + emitted + next committed token) or None when the slot
        is not drafting this step. Returns ``(draft [B, k] int32 padded
        with zeros, lens [B] int32 in [0, k])``."""
        raise NotImplementedError

    def has_candidate(self, ctx: np.ndarray) -> bool:
        """Cheap pre-filter: could :meth:`propose` return a non-empty
        draft for this one context? The engine asks before it commits to
        a serialized proposal round. Default: run a k=1 proposal."""
        _, lens = self.propose([ctx], 1)
        return bool(lens[0])


class PromptLookupProposer(DraftProposer):
    """Prompt-lookup (n-gram) drafting from the request's own context.

    For n from ``ngram_max`` down to ``ngram_min``: take the context's
    last n tokens, find the most recent earlier occurrence of that
    n-gram with a full ``k``-token continuation (the nearest occurrence
    as fallback), and propose up to ``k`` of the tokens that followed
    it. The first n that matches wins. ``ngram_min`` defaults to 2:
    single-token matches fire constantly on random traffic."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 2):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max "
                f"(got {ngram_min}, {ngram_max})")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def _match(self, ctx: np.ndarray, k: int) -> np.ndarray:
        n_ctx = ctx.size
        for n in range(min(self.ngram_max, n_ctx - 1), self.ngram_min - 1,
                       -1):
            tail = ctx[n_ctx - n:]
            # Starts 0 .. n_ctx-n-1: the occurrence at n_ctx-n is the tail
            # itself, with no continuation.
            win = np.lib.stride_tricks.sliding_window_view(ctx[:n_ctx - 1], n)
            hits = np.flatnonzero((win == tail).all(axis=1))
            if hits.size:
                full = hits[hits + n + k <= n_ctx]
                s = int(full[-1]) if full.size else int(hits[-1])
                return ctx[s + n:s + n + k]
        return ctx[:0]

    def propose(self, contexts, k):
        b = len(contexts)
        draft = np.zeros((b, k), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            ctx = np.asarray(ctx, np.int32).reshape(-1)
            if ctx.size < self.ngram_min + 1:
                continue                  # too short to have a match
            got = self._match(ctx, k)
            draft[i, :got.size] = got
            lens[i] = got.size
        return draft, lens


class RadixProposer(DraftProposer):
    """Drafts from the prefix trie's cached continuations.

    The context walks the trie block by block (exact match); the
    remainder (< block_size tokens) must prefix exactly one child's key,
    and the draft is that child's remaining tokens, then a deterministic
    descent (the most recently used child, the key breaking ties) until
    ``k`` tokens or the chain's end. Any mismatch: no draft.

    Read-only: the walk neither pins (a draft must not extend a page's
    life; only the token keys are read) nor touches ``last_use``
    (drafting must not change the eviction order)."""

    def __init__(self, store: PrefixStore):
        self.store = store

    @staticmethod
    def _best_child(node: RadixNode) -> Optional[RadixNode]:
        if not node.children:
            return None
        return max(node.children.values(),
                   key=lambda c: (c.last_use, c.key))

    def propose(self, contexts, k):
        b = len(contexts)
        draft = np.zeros((b, k), np.int32)
        lens = np.zeros((b,), np.int32)
        trie = self.store.trie
        bs = trie.block_size
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            toks = [int(t) for t in np.asarray(ctx, np.int32).reshape(-1)]
            node = trie.root
            n_full = (len(toks) // bs) * bs
            matched = True
            for s in range(0, n_full, bs):
                child = node.children.get(tuple(toks[s:s + bs]))
                if child is None:
                    matched = False
                    break
                node = child
            if not matched:
                continue
            tail = tuple(toks[n_full:])
            out: List[int] = []
            if tail:
                # The remainder must prefix exactly one child edge.
                nxt = next(
                    (c for key, c in node.children.items()
                     if key[:len(tail)] == tail), None)
                if nxt is None:
                    continue
                out.extend(nxt.key[len(tail):])
                node = nxt
            while len(out) < k:
                nxt = self._best_child(node)
                if nxt is None:
                    break
                out.extend(nxt.key)
                node = nxt
            got = np.asarray(out[:k], np.int32)
            draft[i, :got.size] = got
            lens[i] = got.size
        return draft, lens


def make_proposer(name: str,
                  store: Optional[PrefixStore] = None) -> DraftProposer:
    """A proposer by its command-line name: ``"prompt"``, or ``"radix"``,
    which needs the engine's prefix store (``prefix_cache=True``)."""
    if name == "prompt":
        return PromptLookupProposer()
    if name == "radix":
        if store is None:
            raise ValueError(
                "proposer='radix' requires prefix_cache=True "
                "(the radix trie is the draft source)")
        return RadixProposer(store)
    raise ValueError(
        f"unknown proposer {name!r} (expected 'prompt' or 'radix')")
