"""A whole run of each cell, cut to CPU size and with the harness's look
for a card skipped, comes out ``correct``; with the timed path broken
underneath, in each way the cell can break, it does not. The limits are
the cells' own (``workloads/<cell>.json``)."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench.harness import spec
from gpubench.harness.cli import result
from gpubench.tests.helpers import tiny_cell, tiny_ctx

torch.set_num_threads(2)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
#: The serving drivers: the chat cell as it stands, and its traffic from a
#: closed loop of clients (``serve_closed``, which no cell uses yet).
SERVING = ["mixtral_8x7b.chat", "mixtral_8x7b.chat@serve_closed"]


def _run(name, **kw):
    from gpubench.drivers import serve_closed, serve_open, train

    name, _, closed = name.partition("@")
    cell = tiny_cell(name)
    if closed:
        cell.workload["driver"] = closed
        cell.workload["load"] = {"clients": 4}
    driver = {"serve_open": serve_open, "serve_closed": serve_closed,
              "train": train}[cell.workload["driver"]]
    oc = driver.run(tiny_ctx(cell, seconds=1.0, **kw))
    return result(cell, oc, False, "cpu", "")


@pytest.mark.parametrize("name", SERVING + ["mistral_7b.train"])
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    limits = spec.workload_file(name.partition("@")[0])["check"]["limits"]
    assert list(out["checks"]) == list(limits)
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", SERVING)
def test_a_token_altered_where_it_is_produced(name, monkeypatch):
    from kubeflow_controller_tpu_torch.models import generate as gen

    real = gen.decode_step_paged

    def altered(*a, **kw):
        logits, cache = real(*a, **kw)
        nxt = (logits.argmax(-1) + 1) % logits.shape[-1]
        return logits.scatter(-1, nxt[:, None], 1e4), cache

    monkeypatch.setattr(gen, "decode_step_paged", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVING)
def test_half_of_the_requests_never_answered(name, monkeypatch):
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import ServingEngine

    real = ServingEngine.submit

    def half(self, req):
        if req.rid >= 0 and req.rid % 2:
            return None
        return real(self, req)

    monkeypatch.setattr(ServingEngine, "submit", half)
    out = _run(name)
    assert out["failed"] > 0 and not out["correct"]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from kubeflow_controller_tpu_torch import optim

    monkeypatch.setattr(optim.AdamW, "update", lambda self, params, grads: 0.0)
    out = _run("mistral_7b.train")
    assert not out["correct"]
    assert out["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    from gpubench.harness import cli
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    monkeypatch.setattr(tfm, "next_token_loss", tfm.next_token_loss)
    cli.plant_half_batch()
    assert not _run("mistral_7b.train")["correct"]


def test_the_fp8_control_reads_worse_than_the_program():
    """The chat cell's control (the reference with fp8 operands picking
    the tokens) at CPU size: its tokens lie further below the reference's
    best than the served ones, and the check fails."""
    cell = tiny_cell("mixtral_8x7b.chat")
    from gpubench.drivers import serve_open

    oc = serve_open.run(tiny_ctx(cell, control="reference_fp8"))
    sound = oc.extra["program_check_readings"]
    assert oc.checks["mean_gap"] > max(sound["mean_gap"], 1e-6)
    assert not result(cell, oc, False, "cpu", "")["correct"]


def test_the_first_gradient_is_compared_element_by_element():
    """The program's first gradient, as AdamW holds it, against the
    reference's: the training cell's int8 control at CPU size reads a
    larger ``grad_gap`` than the sound run."""
    sound = _run("mistral_7b.train")["checks"]["grad_gap"]["value"]
    low = _run("mistral_7b.train", control="program_int8")["checks"]["grad_gap"]["value"]
    assert 0 < sound < low


def test_the_command_refuses_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, f"{spec.BENCH_DIR}/run.py", "--workload",
                          "mixtral_8x7b.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _card_run(name, *flags):
    out = subprocess.run([sys.executable, f"{spec.BENCH_DIR}/run.py", "--workload", name,
                          "--seed", "4000000001", "--seconds", "10", "--trace", "0",
                          *flags], capture_output=True, text=True, timeout=900,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name, card):
    """Each cell's control (``check.control``: the program's int8 path,
    or the reference with fp8 operands) at the cell's own size fails the
    check."""
    out = _card_run(name, "--control")
    assert out["run"]["control"] == spec.workload_file(name)["check"]["control"]
    assert out["correct"] is False


@pytest.mark.card
def test_half_of_the_batch_left_out_on_the_card(card):
    """Training at its own size: the planted half-batch fault fails the
    check."""
    assert _card_run("mistral_7b.train", "--fault", "half_batch")["correct"] is False
