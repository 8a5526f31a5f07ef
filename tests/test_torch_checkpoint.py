"""The port's optimizer, checkpoints and restarts: twins of the reference's
``tests/test_distributed.py`` optimizer, checkpoint and fault-tolerance
tests (the quadratic, roundtrip and retention, atomic commit, restart),
run on the CPU. The restart resumes bit for bit: the losses after the
fault equal the uninterrupted run's exactly."""
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.runtime.fault_tolerance import run_with_restarts
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop
from repro_torch.training.train_loop import LoopConfig

QUIET = lambda s: None


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Params(nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, nn.Module):
                setattr(self, name, t)
            else:
                setattr(self, name, nn.Parameter(t, requires_grad=False))


def test_optimizer_converges_quadratic():
    state = opt.init_state(_Params(w=torch.tensor([3.0, -2.0])))
    cfg = opt.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                        weight_decay=0.0, grad_clip=10.0)
    for _ in range(150):
        grads = {"w": state.params.w.detach().clone()}   # d/dw (w^2/2)
        state, _ = opt.apply_updates(state, grads, cfg)
    assert float(state.params.w.abs().max()) < 0.05


def _small_state():
    params = _Params(a=torch.arange(6.0).reshape(2, 3),
                     nested=_Params(b=torch.ones(4)))
    state = opt.init_state(params)
    state.m["a"].fill_(0.5)
    state.v["nested.b"].fill_(2.0)
    return state._replace(step=7)


def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = _small_state()
    d = str(tmp_path)
    for s in (10, 20, 30, 40):
        ckpt.save(d, s, state, keep_last=2)
    assert ckpt.latest_step(d) == 40
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040"]
    template = opt.init_state(_Params(a=torch.zeros(2, 3),
                                      nested=_Params(b=torch.zeros(4))))
    restored = ckpt.restore(d, 40, template)
    assert restored.step == 7
    for field in ("m", "v"):
        for name, t in getattr(state, field).items():
            assert torch.equal(getattr(restored, field)[name], t)
    for (n1, a), (n2, b) in zip(state.params.named_parameters(),
                                restored.params.named_parameters()):
        assert n1 == n2 and torch.equal(a, b)


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp directory (simulated crash mid-save) is never 'latest'."""
    d = str(tmp_path)
    ckpt.save(d, 1, opt.init_state(_Params(a=torch.ones(2))))
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1
    assert ckpt.latest_step(os.path.join(d, "missing")) is None


def test_restore_checks_shapes_and_refuses_a_mesh(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, opt.init_state(_Params(a=torch.ones(2))))
    with pytest.raises(ValueError, match="params__a"):
        ckpt.restore(d, 1, opt.init_state(_Params(a=torch.ones(3))))
    # a mesh without the specs of its layout (tests/test_torch_distributed.py
    # restores onto meshes)
    with pytest.raises(ValueError, match="both mesh= and specs="):
        ckpt.restore(d, 1, opt.init_state(_Params(a=torch.ones(2))),
                     mesh=object())


def _restart_setup():
    cfg = configs.reduced(configs.get("smollm-135m"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    opt_cfg = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    return cfg, shape, opt_cfg


def test_train_restart_resumes_deterministically(tmp_path):
    """Crash at step 6, restart from step 5: the re-run steps' losses and
    the final loss equal the uninterrupted run's bit for bit."""
    cfg, shape, opt_cfg = _restart_setup()
    loop = LoopConfig(steps=10, checkpoint_every=5,
                      checkpoint_dir=str(tmp_path / "faulted"), log_every=100)
    report = run_with_restarts(cfg, shape, loop, opt_cfg, fault_at_step=6,
                               log=QUIET, device="cpu")
    assert report.attempts == 2 and report.total_steps_run == 10
    assert report.result["resumed_from"] == 5
    clean_loop = dataclasses.replace(loop,
                                     checkpoint_dir=str(tmp_path / "clean"))
    clean = train_loop.train(cfg, shape, clean_loop, opt_cfg, log=QUIET,
                             device="cpu")
    assert clean["resumed_from"] == 0 and len(clean["losses"]) == 10
    assert report.result["losses"] == clean["losses"][5:]
    assert report.result["final_loss"] == clean["final_loss"]
    assert sorted(os.listdir(tmp_path / "clean")) == ["step_00000005",
                                                      "step_00000010"]
    assert not torch.are_deterministic_algorithms_enabled()


def test_restarts_give_up_after_max(monkeypatch):
    cfg, shape, opt_cfg = _restart_setup()
    calls = []

    def failing(*a, **k):
        calls.append(1)
        raise RuntimeError("node lost")
    monkeypatch.setattr(train_loop, "train", failing)
    with pytest.raises(RuntimeError, match="node lost"):
        run_with_restarts(cfg, shape, LoopConfig(steps=2), opt_cfg,
                          max_restarts=2, log=QUIET, device="cpu")
    assert len(calls) == 3


def test_restore_into_a_fresh_model_init(tmp_path):
    """A port checkpoint restores into another draw's ``init_state``: the
    masters, moments and step become the saved ones, and the next step's
    loss equals the one the saved run would take."""
    cfg, shape, opt_cfg = _restart_setup()
    loop = LoopConfig(steps=3, checkpoint_every=3,
                      checkpoint_dir=str(tmp_path), log_every=100)
    train_loop.train(cfg, shape, loop, opt_cfg, log=QUIET, device="cpu")
    template = opt.init_state(build(cfg).init(seed=1, device="cpu"))
    before = template.params.embed.table.clone()
    state = ckpt.restore(str(tmp_path), 3, template)
    assert state.step == 3
    assert not torch.equal(state.params.embed.table, before)
    saved = np.load(tmp_path / "step_00000003" / "params__embed__table.npy")
    np.testing.assert_array_equal(state.params.embed.table.numpy(), saved)
    longer = dataclasses.replace(loop, steps=4)
    resumed = train_loop.train(cfg, shape, longer, opt_cfg, log=QUIET,
                               device="cpu")
    straight = train_loop.train(cfg, shape, dataclasses.replace(
        longer, checkpoint_dir=None), opt_cfg, log=QUIET, device="cpu")
    assert resumed["resumed_from"] == 3
    assert resumed["losses"] == straight["losses"][3:]


def test_train_cli_restarts(tmp_path, capsys):
    """``launch.train.main`` with an injected fault: two attempts."""
    assert train_cli.main([
        "--arch", "smollm-135m", "--reduced", "--steps", "4", "--batch", "2",
        "--seq", "32", "--device", "cpu", "--checkpoint-every", "2",
        "--checkpoint-dir", str(tmp_path), "--fault-at-step", "3"]) == 0
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out
    assert "[done after 2 attempts] loss" in out
