"""What each model-step call of the serving path was given, logged while
a traced slice runs: the benchmark wraps the port's
``models/generate.py`` entry points that the engine calls by module
attribute, and logs their inputs (device copies, read after the slice,
so nothing waits on the device). The per-layer readers count each
call's work from these logs: a decode micro-step's active slots and
their lengths, a block prefill's prompt length, a prefill chunk's width
and offset."""

from __future__ import annotations

from typing import List, Tuple

import torch


class Recorder:
    def __init__(self):
        self.on = False
        self.decode: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.prefill: List[int] = []
        self.chunks: List[Tuple[int, int]] = []
        self._saved = {}

    def install(self) -> None:
        from kubeflow_controller_tpu_torch.models import generate as gen

        dec, pre, chk = gen.decode_step_paged, gen.prefill_into_paged, gen.prefill_chunk_paged
        self._saved = {"decode_step_paged": dec, "prefill_into_paged": pre,
                       "prefill_chunk_paged": chk}

        def decode_step_paged(cfg, params, tokens, cache, *a, **kw):
            if self.on:
                self.decode.append((cache.length.clone(), cache.active.clone()))
            return dec(cfg, params, tokens, cache, *a, **kw)

        def prefill_into_paged(cfg, params, prompt, *a, **kw):
            if self.on:
                self.prefill.append(int(prompt.shape[1]))
            return pre(cfg, params, prompt, *a, **kw)

        def prefill_chunk_paged(cfg, params, toks, cache, slot, offset, n_real, *a, **kw):
            if self.on:
                self.chunks.append((int(n_real), int(offset)))
            return chk(cfg, params, toks, cache, slot, offset, n_real, *a, **kw)

        gen.decode_step_paged = decode_step_paged
        gen.prefill_into_paged = prefill_into_paged
        gen.prefill_chunk_paged = prefill_chunk_paged

    def uninstall(self) -> None:
        from kubeflow_controller_tpu_torch.models import generate as gen

        for name, fn in self._saved.items():
            setattr(gen, name, fn)
        self._saved = {}

    def decode_contexts(self) -> List[List[int]]:
        """Each logged micro-step's active slots' attended columns: a
        slot at length ``p`` writes its new key at ``p`` and attends
        ``p + 1``."""
        out = []
        for length, active in self.decode:
            ln, ac = length.cpu(), active.cpu()
            out.append([int(x) + 1 for x, a in zip(ln.tolist(), ac.tolist()) if a])
        return out
