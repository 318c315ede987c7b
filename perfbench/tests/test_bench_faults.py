"""A run with the timed path broken underneath comes out not correct: each
fault a serving cell can have, planted in the port, on a dry run of the
whole harness on the CPU (the card's look skipped).  And each cell's
control, the program's own int8 path or the reference in float8 in the
program's place, reads further from the reference than the program."""

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from perfbench.harness import check  # noqa: E402


SERVE = ["sd15-serve-c16", "sdxl-serve-c8"]
# each serving cell's control (PERF.md gives the readings behind the choice)
CONTROL = {"sd15-serve-c16": "w8a8", "sdxl-serve-c8": "fp8"}
DRY_CONTROL = {"w8a8": "w8a8:1", "fp8": "fp8"}  # int8 from the first layer at the tiny sizes


def dry_run(capsys, workload="sd15-serve-c16", *extra):
    rc = run.main(["--workload", workload, "--seed", "2147483659", "--seconds", "3", "--trace", "0",
                   "--dry-run", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def every_sample(monkeypatch):
    """Compare every completed request, so a fault in some rows is seen."""
    monkeypatch.setattr(check, "sample", lambda log, n, seed: [r for r in log if r["ok"]])


@pytest.mark.parametrize("workload", SERVE)
def test_sound_run_is_correct(workload, capsys, every_sample):
    assert dry_run(capsys, workload)["correct"] is True


@pytest.mark.parametrize("workload", SERVE)
def test_step_returning_its_state_unchanged(workload, capsys, every_sample, monkeypatch):
    from stablediffusion_tpu_torch.schedulers.ddim import DDIMScheduler

    monkeypatch.setattr(DDIMScheduler, "step", lambda self, plan, state, i, out, sample, noise=None:
                        (sample, state))
    assert dry_run(capsys, workload)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_half_the_batch_left_out(workload, capsys, every_sample, monkeypatch):
    from stablediffusion_tpu_torch.serve.handler import Handler

    inner = Handler._generate

    def half(self, args, output_type="uint8"):
        n = len(args["prompt"])
        if n < 2:
            return inner(self, args, output_type)
        keep = (n + 1) // 2
        out = inner(self, {**args, **{k: args[k][:keep] for k in ("prompt", "negative_prompt", "seed")}},
                    output_type)
        out.images = torch.cat([out.images, out.images[: n - keep]])
        out.seed = list(out.seed) + list(out.seed[: n - keep])
        return out

    monkeypatch.setattr(Handler, "_generate", half)
    assert dry_run(capsys, workload)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_answer_altered_where_produced(workload, capsys, every_sample, monkeypatch):
    from stablediffusion_tpu_torch.serve.handler import Handler

    inner = Handler._generate

    def altered(self, args, output_type="uint8"):
        out = inner(self, args, output_type)
        out.images = out.images + 64  # uint8 wraps: every pixel moved
        return out

    monkeypatch.setattr(Handler, "_generate", altered)
    assert dry_run(capsys, workload)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_seeds_swapped_between_slots(workload, capsys, every_sample, monkeypatch):
    from stablediffusion_tpu_torch.serve.handler import Handler

    inner = Handler._generate

    def swapped(self, args, output_type="uint8"):
        s = list(args["seed"])
        return inner(self, {**args, "seed": s[1:] + s[:1]}, output_type)

    monkeypatch.setattr(Handler, "_generate", swapped)
    assert dry_run(capsys, workload)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_control_reads_further_than_the_program(capsys, every_sample, workload):
    from perfbench.harness import registry

    sound, control = dry_run(capsys, workload)["checks"], \
        dry_run(capsys, workload, "--control", DRY_CONTROL[CONTROL[workload]])["checks"]
    assert any(control[k]["value"] > sound[k]["value"] for k in registry.limits(workload))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVE)
def test_control_fails_at_the_cells_size(capsys, workload):
    """On the card, at the cell's own sizes: the control is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rc = run.main(["--workload", workload, "--seed", "2147483671", "--seconds", "10", "--trace", "0",
                   "--control", CONTROL[workload]])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is False


def train_run(capsys, *extra):
    rc = run.main(["--workload", "sd15-train-b16", "--seed", "2147483693", "--seconds", "2",
                   "--trace", "0", "--dry-run", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_sound_run_is_correct(capsys):
    assert train_run(capsys)["correct"] is True


def test_train_step_returning_its_state_unchanged(capsys, monkeypatch):
    from stablediffusion_tpu_torch.train.optim import AdamW

    monkeypatch.setattr(AdamW, "update", lambda self, grads, state, params: (params, state))
    line = train_run(capsys)
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)
    assert line["correct"] is False


def test_train_half_the_batch_left_out(capsys, monkeypatch):
    from stablediffusion_tpu_torch.train import train_step

    inner = train_step._prediction_loss

    def half(pred, latents, noise, timesteps, statics, scheduler):
        h = pred.shape[0] // 2
        return inner(pred[:h], latents[:h], noise[:h], timesteps[:h], statics, scheduler)

    monkeypatch.setattr(train_step, "_prediction_loss", half)
    assert train_run(capsys)["correct"] is False


def test_train_answer_altered_where_produced(capsys, monkeypatch):
    from stablediffusion_tpu_torch.train import train_step

    inner = train_step._unet_pred
    monkeypatch.setattr(train_step, "_unet_pred", lambda *a, **k: inner(*a, **k) * 1.1)
    assert train_run(capsys)["correct"] is False


def test_train_reference_follows_the_datasets_flips(capsys, monkeypatch):
    """The reference mirrors the rows the dataset flipped, and only those:
    with the bits inverted, the same steps are not correct."""
    from perfbench.harness import train

    inner = train.flips_of
    monkeypatch.setattr(train, "flips_of", lambda batch, d: [not f for f in inner(batch, d)])
    assert train_run(capsys)["correct"] is False


def test_train_control_reads_further_than_the_program(capsys):
    sound = train_run(capsys)["checks"]
    control = train_run(capsys, "--control", "fp8")["checks"]
    for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"):
        assert control[k]["value"] > sound[k]["value"]
