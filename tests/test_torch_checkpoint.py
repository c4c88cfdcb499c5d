"""PyTorch port: checkpoints, preemption and the training launcher.

Mirrors of ``tests/test_checkpoint.py`` on the port (save → restore →
train ≡ uninterrupted train, bit for bit on the CPU; a crash mid-write is
ignored; ``keep`` prunes; a structure mismatch is refused; the preemption
guard), then checkpoints across the packages: one written by the JAX
package is restored by the port, and one written by the port by the JAX
package, with equal leaves — the two share the on-disk layout and leaf
order.  Last, the launcher: SIGTERM checkpoints and exits, and the same
command resumes to the uninterrupted run's weights.
"""

import dataclasses
import io
import os
import shutil
import signal
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import load_smoke
from repro_torch.data import pipeline
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, convert
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import PreemptionGuard, elastic_restore
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.train_loop import init_train_state, make_train_step
from test_torch_models import reference_params, tensor, to_np


def _setup(microbatches=1):
    cfg = load_smoke("granite_3_2b")
    opt_cfg = OptConfig(warmup_steps=2, total_steps=20)
    model, opt_state = init_train_state(
        build_model(cfg, "cpu"), torch.Generator().manual_seed(0), opt_cfg)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches)
    data = SyntheticLMData(cfg, seq_len=16, global_batch=4)
    return model, opt_state, step_fn, data, opt_cfg


def _fresh(opt_cfg):
    model = build_model(load_smoke("granite_3_2b"), "cpu")
    model.init(torch.Generator().manual_seed(123))
    return model, init_opt_state(model.parameters(), opt_cfg)


def _state_tensors(model, opt) -> list:
    return ([p.detach() for p in model.parameters()] + [opt.step] +
            list(opt.mu) + list(opt.nu) + list(opt.master))


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def test_save_restore_exact_resume(tmp_path):
    model, opt, step_fn, data, opt_cfg = _setup()
    for s in range(3):
        opt, _ = step_fn(opt, data.batch_at(s))
    ckpt.save(str(tmp_path), 3, {"params": model, "opt": opt})
    for s in range(3, 6):
        opt, _ = step_fn(opt, data.batch_at(s))
    want = [t.clone() for t in _state_tensors(model, opt)]

    model2, opt2 = _fresh(opt_cfg)
    state, step = ckpt.restore_latest(str(tmp_path),
                                      {"params": model2, "opt": opt2})
    assert step == 3 and state["params"] is model2
    opt2 = state["opt"]
    assert int(opt2.step) == 3
    step2 = make_train_step(model2, opt_cfg)
    for s in range(3, 6):
        opt2, _ = step2(opt2, data.batch_at(s))
    assert _equal(_state_tensors(model2, opt2), want), \
        "resume diverged from uninterrupted run"


def test_crash_mid_write_ignored(tmp_path):
    model, opt, _, _, _ = _setup()
    ckpt.save(str(tmp_path), 1, {"params": model})
    # simulate a crash: a half-written .tmp dir for step 2
    os.makedirs(tmp_path / "step_00000002.tmp")
    with open(tmp_path / "step_00000002.tmp" / "leaf_00000.npy", "wb") as f:
        f.write(b"garbage")
    _, step = ckpt.restore_latest(str(tmp_path), {"params": model})
    assert step == 1  # the committed one


def test_keep_prunes_old(tmp_path):
    model, _, _, _, _ = _setup()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"params": model}, keep=2)
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert names == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_structure_mismatch_rejected(tmp_path):
    model, opt, _, _, _ = _setup()
    ckpt.save(str(tmp_path), 1, {"params": model})
    with pytest.raises(ValueError):          # leaf count
        ckpt.restore(str(tmp_path), 1, {"params": model, "opt": opt})
    wider = build_model(dataclasses.replace(load_smoke("granite_3_2b"),
                                            d_ff=96), "cpu")
    with pytest.raises(ValueError):          # shapes
        ckpt.restore(str(tmp_path), 1, {"params": wider})


def test_preemption_guard_checkpoints_and_stops(tmp_path):
    model, opt, step_fn, data, _ = _setup()
    guard = PreemptionGuard(signals=())
    saved_at = None
    for s in range(10):
        if s == 4:
            guard.trigger()           # simulated SIGTERM
        opt, _ = step_fn(opt, data.batch_at(s))
        if guard.should_stop:
            ckpt.save(str(tmp_path), s, {"params": model, "opt": opt})
            saved_at = s
            break
    assert saved_at == 4
    state, step = elastic_restore(str(tmp_path),
                                  {"params": model, "opt": opt}, "cpu")
    assert step == 4 and state["opt"].step.device.type == "cpu"
    assert int(state["opt"].step) == 5


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


CROSS = [("granite_3_2b", {}),
         ("gemma3_27b", {}),             # tail layers, qk-norm, 6 blocks
         ("recurrentgemma_2b", {}),      # RG-LRU groups and tail layers
         ("mamba2_13b", {}),             # SSD blocks, f32 vectors
         ("whisper_large_v3", {}),       # enc/dec stacks
         ("deepseek_v2_236b", {}),       # dense prefix, MoE groups, MLA
         ("deepseek_v3_671b", {}),       # + the MTP head
         ("granite_3_2b", {"moments_dtype": "bfloat16", "use_master": False})]


def _jax_state(arch, kw):
    """A JAX param tree and an optimizer state two AdamW steps in (random
    grads), so moments and master copies are nonzero."""
    jc = jconfigs.load_smoke(arch)
    params = reference_params(jc, seed=4)
    cfg = jopt.OptConfig(**kw)
    opt = jopt.init_opt_state(params, cfg)
    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32), p.dtype), params)
        params, opt, _ = jopt.apply_updates(cfg, params, grads, opt)
    return params, opt, cfg


def _leaves_equal(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(np.asarray(g, np.float64),
                              np.asarray(w, np.float64))


@pytest.mark.parametrize("arch,kw", CROSS)
def test_port_restores_a_jax_checkpoint(tmp_path, arch, kw):
    params, opt, _ = _jax_state(arch, kw)
    jckpt.save(str(tmp_path), 2, {"params": params, "opt": opt})
    model = build_model(load_smoke(arch), "cpu")
    model.init(torch.Generator().manual_seed(0))
    like = {"params": model, "opt": init_opt_state(model.parameters(),
                                                   OptConfig(**kw))}
    state, step = ckpt.restore_latest(str(tmp_path), like)
    assert step == 2
    got = state["opt"]
    assert int(got.step) == int(opt.step) == 2
    # the port's state, carried back into the reference layout
    back = {"params": jax.tree.map(to_np, convert.reference_tree(
        model, model.parameters())),
        "opt": jax.tree.map(to_np, convert.reference_opt_tree(model, got))}
    want = {"params": params, "opt": tuple(opt)}
    for k in ("params", "opt"):
        assert len(jax.tree.leaves(back[k])) == len(jax.tree.leaves(want[k]))
        for g, w in zip(jax.tree.leaves(back[k]), jax.tree.leaves(want[k])):
            assert np.array_equal(g, to_np(w))
    dtypes = {t.dtype for t in got.mu}
    assert dtypes == ({torch.bfloat16} if kw else {torch.float32})
    assert (got.master == ()) == bool(kw)


@pytest.mark.parametrize("arch,kw", CROSS)
def test_jax_restores_a_port_checkpoint(tmp_path, arch, kw):
    params, opt, cfg = _jax_state(arch, kw)
    model = build_model(load_smoke(arch), "cpu")
    model.init(torch.Generator().manual_seed(0))
    tcfg = OptConfig(**kw)
    topt = init_opt_state(model.parameters(), tcfg)
    rng = np.random.default_rng(6)
    for _ in range(2):
        grads = [tensor(rng.standard_normal(p.shape).astype(np.float32),
                        p.dtype) for p in model.parameters()]
        topt, _ = apply_updates(tcfg, list(model.parameters()), grads, topt)
    ckpt.save(str(tmp_path), 7, {"params": model, "opt": topt})
    state, step = jckpt.restore_latest(str(tmp_path),
                                       {"params": params, "opt": opt})
    assert step == 7
    want = {"params": convert.reference_tree(model, model.parameters()),
            "opt": convert.reference_opt_tree(model, topt)}
    _leaves_equal(jax.tree.map(to_np, state["params"]),
                  jax.tree.map(lambda t: t.float().numpy(), want["params"]))
    got_opt = tuple(state["opt"])
    assert int(got_opt[0]) == 2
    _leaves_equal(jax.tree.map(to_np, got_opt[1:]),
                  jax.tree.map(lambda t: t.float().numpy(), want["opt"][1:]))
    for g, w in zip(jax.tree.leaves(state["params"]),
                    jax.tree.leaves(params)):
        assert g.dtype == w.dtype and g.shape == w.shape


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


ARGS = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--steps",
        "6", "--seq-len", "16", "--global-batch", "4", "--microbatches", "2",
        "--log-every", "1"]


def test_launcher_sigterm_checkpoints_and_the_same_command_resumes(
        tmp_path, monkeypatch):
    """SIGTERM during step 2: the step finishes, is checkpointed, and the
    run exits; the same command then resumes at step 3 and ends with the
    weights and optimizer state of an uninterrupted run, bit for bit."""
    handler = signal.getsignal(signal.SIGTERM)
    want = train_cli.run(ARGS)
    want = [t.clone() for t in _state_tensors(want["model"],
                                              want["opt_state"])]

    batch_at = pipeline.SyntheticLMData.batch_at

    def preempt_at_2(self, step):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)
        return batch_at(self, step)
    monkeypatch.setattr(pipeline.SyntheticLMData, "batch_at", preempt_at_2)
    out = io.StringIO()
    args = ARGS + ["--ckpt-dir", str(tmp_path), "--save-every", "50"]
    with redirect_stdout(out):
        first = train_cli.run(args)
    assert "preempted — checkpointed at step 2" in out.getvalue()
    assert [r["step"] for r in first["records"]] == [0, 1, 2]
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert signal.getsignal(signal.SIGTERM) == handler

    monkeypatch.setattr(pipeline.SyntheticLMData, "batch_at", batch_at)
    out = io.StringIO()
    with redirect_stdout(out):
        second = train_cli.run(args)
    assert "resumed from step 2" in out.getvalue()
    assert [r["step"] for r in second["records"]] == [3, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["opt_s"] >= 0
               for r in second["records"])
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert _equal(_state_tensors(second["model"], second["opt_state"]), want)
    assert train_cli.main(args) == 0          # nothing left: prints "done"


def test_launcher_refuses_the_production_mesh():
    """One rank cannot hold the 16×16 mesh: the launcher exits naming the
    256 ranks it needs and the 1 it found."""
    with pytest.raises(SystemExit, match=r"needs 256 ranks; found 1$"):
        train_cli.main(ARGS + ["--production-mesh"])


def test_launcher_trains_a_callers_model():
    """``run(argv, model=...)`` trains the caller's weights in place (the
    same steps as from the launcher's own init when they are equal) and
    refuses a model of another config or device."""
    want = train_cli.run(ARGS)
    model = build_model(load_smoke("granite_3_2b"), "cpu")
    model.init(torch.Generator().manual_seed(0))
    got = train_cli.run(ARGS, model=model)
    assert got["model"] is model
    assert _equal(_state_tensors(model, got["opt_state"]),
                  _state_tensors(want["model"], want["opt_state"]))
    other = build_model(load_smoke("qwen3_32b"), "cpu")
    with pytest.raises(ValueError):
        train_cli.run(ARGS, model=other)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_13b",
                                  "whisper_large_v3", "deepseek_v2_236b",
                                  "deepseek_v3_671b"])
def test_launcher_trains_and_resumes_each_family(tmp_path, arch):
    """The launcher, unchanged, over the hybrid, SSM, encoder-decoder and
    DeepSeek SMOKE configs: 3 steps in 2 microbatches with finite losses and a
    checkpoint after each; with the last checkpoint removed, the same
    command resumes from step 1 to the uninterrupted run's state."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len",
            "16", "--global-batch", "4", "--microbatches", "2",
            "--log-every", "1", "--steps", "3", "--save-every", "1",
            "--ckpt-dir", str(tmp_path)]
    with redirect_stdout(io.StringIO()):
        whole = train_cli.run(args)
        shutil.rmtree(tmp_path / "step_00000002")
        resumed = train_cli.run(args)
    assert all(np.isfinite(r["loss"]) for r in whole["records"])
    assert [r["step"] for r in resumed["records"]] == [2]
    assert resumed["records"][0]["loss"] == whole["records"][2]["loss"]
    assert _equal(_state_tensors(resumed["model"], resumed["opt_state"]),
                  _state_tensors(whole["model"], whole["opt_state"]))
