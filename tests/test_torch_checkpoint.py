"""Checkpoints from training to serving in the port: ``TrainLoop`` save
and resume (``dataplane/train.py``), ``lm.train`` into a job's model
dir, and ``serve(model_dir)``.

The JAX package checkpoints through orbax, which the port does not read
(its own format is ``torch.save`` into ``model_dir/<step>/``), so these
tests hold the port to the reference's contracts rather than to its
bytes: a resumed run continues exactly where the saved one stopped (the
same losses, bit for bit, on the same batches: fp32 on the CPU), the
newest ``keep_checkpoints`` survive, a save cut short is never picked,
and serving the saved directory streams what the trained params stream
in memory.
"""

import json
import os

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu_torch import optim
from kubeflow_controller_tpu_torch.convert import tree_leaves
from kubeflow_controller_tpu_torch.dataplane import train as ttrain
from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm as tlm
from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttf

CFG = ttf.tiny_config()
BATCHES = [next(tlm.synthetic_lm(CFG.vocab_size, 4, 32, seed=s)) for s in range(6)]
OPTIMIZERS = [False, True]
OPT_IDS = ["adamw", "adamw8bit"]


def _loop(model_dir, total, opt8bit=False, every=0, keep=3):
    return ttrain.TrainLoop(
        init_fn=ttf.make_init_fn(CFG), loss_fn=ttf.make_loss_fn(CFG),
        optimizer=optim.make_optimizer(1e-2, 6, opt8bit),
        config=ttrain.TrainLoopConfig(total_steps=total, log_every=1,
                                      checkpoint_every=every,
                                      keep_checkpoints=keep),
        model_dir=model_dir, device="cpu")


def _run(loop, batches):
    losses = []
    loop.run(ttrain.device_prefetch(iter(batches), "cpu"),
             on_metrics=lambda m: losses.append(m.loss))
    return losses


def _opt_tensors(tx):
    state = tx.state_dict()
    if "opt" in state:
        out = [state["count"]]
        for leaf in state["opt"]["state"].values():
            out += [leaf[k] for k in sorted(leaf)]
        return out
    return [state["count"]] + [t for leaf in state["m"] + state["v"]
                               for t in leaf.values()]


@pytest.mark.parametrize("opt8bit", OPTIMIZERS, ids=OPT_IDS)
def test_restored_state_equals_saved_bit_for_bit(opt8bit, tmp_path):
    """After 3 steps and a save, a fresh loop's restore() brings back the
    step, every parameter and the optimizer's whole state (AdamW's moments
    and counts, or AdamW8bit's codes and scales) bit for bit."""
    saved = _loop(str(tmp_path), 3, opt8bit)
    _run(saved, BATCHES[:3])
    assert ttrain.checkpoint_steps(str(tmp_path)) == [3]
    fresh = _loop(str(tmp_path), 6, opt8bit)
    assert fresh.restore() and fresh.state.step == 3
    for a, b in zip(tree_leaves(saved.state.params),
                    tree_leaves(fresh.state.params)):
        assert torch.equal(a, b)
    got, want = _opt_tensors(fresh.tx), _opt_tensors(saved.tx)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    if not opt8bit:
        assert fresh.tx.opt.param_groups[0]["lr"] == saved.tx.opt.param_groups[0]["lr"]


@pytest.mark.parametrize("opt8bit", OPTIMIZERS, ids=OPT_IDS)
def test_resumed_losses_equal_the_uninterrupted_run(opt8bit, tmp_path):
    """Train 3 steps saving every step, then resume to 6 on the next
    batches: the 6 losses equal an uninterrupted 6-step run's bit for
    bit."""
    whole = _run(_loop("", 6, opt8bit), BATCHES)
    first = _run(_loop(str(tmp_path), 3, opt8bit, every=1), BATCHES[:3])
    resumed = _loop(str(tmp_path), 6, opt8bit)
    rest = _run(resumed, BATCHES[3:])
    assert resumed.start_step == 3
    assert first + rest == whole


def test_keep_checkpoints_prunes(tmp_path):
    """Saving every step keeps only the newest ``keep_checkpoints``; the
    end-of-run save of an already-saved step writes nothing new."""
    _run(_loop(str(tmp_path), 5, every=1, keep=2), BATCHES[:5])
    assert ttrain.checkpoint_steps(str(tmp_path)) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["4", "5"]
    assert sorted(os.listdir(tmp_path / "5")) == ["opt.pt", "params.pt"]


def test_crash_between_write_and_rename_keeps_the_previous(tmp_path, monkeypatch):
    """A save cut short after its files are written but before the rename
    leaves the previous checkpoint as the latest: a new loop restores
    that one, and its next save clears the leftover."""
    loop = _loop(str(tmp_path), 1, every=1)
    _run(loop, BATCHES[:1])
    real = os.rename

    def crash(src, dst):
        raise OSError("preempted")

    loop.config.total_steps = 2
    monkeypatch.setattr(ttrain.os, "rename", crash)
    with pytest.raises(OSError, match="preempted"):
        _run(loop, BATCHES[1:2])
    monkeypatch.setattr(ttrain.os, "rename", real)
    assert ttrain.checkpoint_steps(str(tmp_path)) == [1]
    assert any(n.startswith(".tmp-2-") for n in os.listdir(tmp_path))
    again = _loop(str(tmp_path), 2)
    assert again.restore() and again.state.step == 1
    _run(again, BATCHES[1:2])
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]


def test_lm_train_honours_the_job_model_dir(tmp_path):
    """``lm.train`` trains into ``ctx.model_dir`` (TPUJOB_MODEL_DIR) when
    no model_dir is passed, saving every ``checkpoint_every`` steps, and
    a second run resumes there at the saved step; an explicit
    ``model_dir`` wins over the job's."""
    ctx = ProcessContext(model_dir=str(tmp_path / "job"), log_dir=str(tmp_path))
    kw = dict(config="tiny", per_data_shard_batch=2, seq_len=32, device="cpu")
    out = tlm.train(ctx, total_steps=4, checkpoint_every=2, **kw)
    assert out["final_step"] == 4 and np.isfinite(out["loss"])
    assert ttrain.checkpoint_steps(str(tmp_path / "job")) == [2, 4]
    out = tlm.train(ctx, total_steps=5, **kw)
    assert (out["start_step"], out["final_step"]) == (4, 5)
    tlm.train(ctx, total_steps=2, model_dir=str(tmp_path / "mine"), **kw)
    assert ttrain.checkpoint_steps(str(tmp_path / "mine")) == [2]
    assert ttrain.checkpoint_steps(str(tmp_path / "job")) == [2, 4, 5]


def test_serve_streams_what_the_trained_params_stream(tmp_path, caplog):
    """serve(model_dir) restores the latest checkpoint's params (cast as
    inference_params casts them) and streams the tokens an engine on the
    loop's in-memory params streams, reporting restored_step; the CLI's
    --model-dir does the same. An empty directory serves the fresh init
    with a warning and restored_step -1."""
    loop = _loop(str(tmp_path), 3)
    _run(loop, BATCHES[:3])
    params = tgen.inference_params(CFG, loop.state.params)
    prompts = serve_lm._read_prompts("", CFG.vocab_size, 3, 9)
    eng = ServingEngine(CFG, params, n_slots=3, max_seq=9 + 6, device="cpu")
    want = {c.rid: c.tokens for c in eng.run([
        Request(rid=i, prompt=prompts[i], max_new_tokens=6) for i in range(3)])}
    out_file = tmp_path / "out.jsonl"
    res = serve_lm.serve(config="tiny", model_dir=str(tmp_path), batch=3,
                         prompt_len=9, max_new_tokens=6, device="cpu",
                         output_file=str(out_file))
    assert res["restored_step"] == 3
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert {r["rid"]: r["completion"] for r in rows} == want
    assert serve_lm.main(["--config", "tiny", "--device", "cpu", "--batch", "3",
                          "--prompt-len", "9", "--max-new-tokens", "6",
                          "--model-dir", str(tmp_path),
                          "--output", str(out_file)]) == 0
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert {r["rid"]: r["completion"] for r in rows} == want
    with caplog.at_level("WARNING", logger="tpujob.serve_lm_torch"):
        res = serve_lm.serve(config="tiny", model_dir=str(tmp_path / "none"),
                             batch=3, prompt_len=9, max_new_tokens=6,
                             device="cpu")
    assert res["restored_step"] == -1 and "no checkpoint found" in caplog.text
