#!/usr/bin/env python3
"""Time one tree of the port on the card, for an A/B of two commits.

    python3 chip_ab.py ROOT TAG

Imports ``chip_smoke`` and the port from ROOT (a checkout, for example a
``git archive`` of the parent unpacked under ``build/``) and prints one
line ``AB {json}``: the flash kernels at llama3_8b's and the flagship's
attention shapes (``FlashCase.run``, timed: whole call by CUDA events,
device time by kernel, SDPA, bound) and the llama3_8b train step at
2 layers, B2 S2048, in bf16 (8 steps) and under ``quant="int8_fused"``
(4), with exact launch counts (``train_run``). Compare two trees only
inside one call on one card, in turns: parent, change, change, parent.
Needs one card; runs nothing on the CPU.
"""

import json
import os
import sys


def main(root: str, tag: str) -> int:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = c.device_phase()
    fails, out = [], {}
    for shape in ("llama3_8b", "flagship"):
        case = c.FlashCase(shape, segments=False, seed=20, **c.FLASH_SHAPES[shape])
        for k, r in case.run(smi, True, fails).items():
            out[f"{shape}/{k}"] = {x: r.get(x) for x in (
                "ms", "library_ms", "bound_ms", "max_abs_err", "device_ms_by_kernel",
                "two_pass_route_ms", "fused_route_ms")}
        del case
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(fails)
    llama = tfm.llama3_8b_config(n_layers=2, max_seq=2048, attn_impl="flash")
    n = llama.n_layers
    # A tree with the two-pass route of flash_bwd_two_pass shares one rope
    # prepass between the passes and takes delta from the prepass kernel.
    if hasattr(fa, "flash_bwd_two_pass"):
        want = {"rope_rotate": 3 * n, "flash_bwd_prep": n}
    else:
        want = {"rope_rotate": 2 * n}
    want.update(flash_fwd=2 * n, flash_bwd_dkdv=n, flash_bwd_dq=n)
    int8 = {"int8_quantize_rows": 16 * n, "int8_matmul": 16 * n}
    for label, cfg, steps, extra in (
            ("llama3_8b", llama, 8, {}),
            ("llama3_8b.int8_fused", llama.replace(quant="int8_fused"), 4, int8)):
        r = c.train_run(label, cfg, 2048, 2, steps, {**want, **extra}, smi)
        out["train/" + label] = {x: r[x] for x in (
            "step_ms", "step_ms_all", "profiled_step_device_ms", "mfu", "tokens_per_s",
            "idle_share", "device_ms_by_kernel", "peak_gb")}
    print("AB " + json.dumps({"tag": tag, "smi": smi, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
