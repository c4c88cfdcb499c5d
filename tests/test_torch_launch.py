"""PyTorch port: the launcher's sharding plan and its sharded steps.

* **Placements.**  Every parameter's spec on both production meshes
  (16×16 ``("data", "model")`` and 2×16×16 ``("pod", "data", "model")``)
  equals the JAX package's ``spec_for`` on the same logical axes and
  shape, for all ten configs at full width.  The reference side reads
  only ``repro.launch.sharding.rules_for`` and ``spec_for`` (what its
  ``_resolve_dim`` reads), called with a namespace mesh (``axis_names``
  and a ``shape`` dict); its axes come from ``jax.eval_shape`` of the
  model's ``init_tree`` and ``split_params``.  A stacked group leaf's
  leading ``"layers"`` entry (never sharded) is dropped, since the port
  keeps one parameter per layer.  Cache and batch specs are held the same
  way, against the reference's cache leaf table and rules.
* **``shard_act``** is the identity without a rule: every config's SMOKE
  logits are bit-equal with and without an identity rule installed, and
  the rule sees the reference's activation axes.
* **Sharded steps** run in a child process that spawns 8 gloo ranks over
  a ``FileStore`` under ``tmp_path`` (no TCP port), so no process group
  ever lives in a test worker (the ``no_process_group`` fixture checks):
  granite SMOKE in float32, ``wq``/``wk`` at a quarter of the init scale
  (the whole-model convention of ``test_torch_models.py``), one
  2-microbatch train step on a 2×4 ``("data", "model")`` mesh against
  one device, prefill + decode with the cache placed by
  ``cache_sharding_tree`` on a 1×8 mesh, each under the TP plan and
  under granite's own pure-DP plan, and the launcher on an 8-rank
  ``("data",)`` mesh.  Tolerance: float32 1e-5 of scale (loss, gradients,
  logits); the updated parameters too, except where a gradient element
  is under the rounding noise (≤ 1e-5 of its leaf's scale), where Adam's
  sign-like first step may go either way and 2.5 · lr is allowed
  (``test_torch_train.py``'s rule).
"""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as jsh
from repro.models import build_model as jbuild
from repro.models.layers import split_params
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import stack_plan

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCHS = tconfigs.ARCH_IDS
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def ns_mesh(kind: str):
    shape, axes = MESHES[kind]
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))


@pytest.fixture(autouse=True)
def no_process_group():
    yield
    assert not torch.distributed.is_initialized()


class Stacked:
    """A reference spec with its leaf's shape, sliceable along the layer
    axis the way ``convert.reference_state`` slices a stacked leaf."""

    def __init__(self, shape, spec):
        self.shape, self.spec = tuple(shape), tuple(spec)

    def __getitem__(self, i):
        assert self.spec[0] is None, "a layer axis is never sharded"
        return Stacked(self.shape[1:], self.spec[1:])


def reference_param_specs(arch: str, mesh, cfg) -> dict:
    """{port parameter name: the reference's spec of that leaf}."""
    from repro_torch.models import convert
    jcfg = jconfigs.load_arch(arch)
    tree = jax.eval_shape(jbuild(jcfg).init_tree, jax.random.PRNGKey(0))
    shapes, axes = split_params(tree)
    rules = jsh.rules_for(jcfg, mesh)[0]
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    specs = jax.tree.map(
        lambda s, a: Stacked(s.shape,
                             tuple(jsh.spec_for(mesh, rules, a, s.shape))),
        shapes, axes, is_leaf=lambda x: x is None or is_axes(x))
    flat = convert.reference_state(tbuild(cfg, "meta"), specs)
    return {k: v.spec for k, v in flat.items()}


@pytest.mark.parametrize("mesh_kind", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_kind):
    cfg = tconfigs.load_arch(arch)
    mesh = ns_mesh(mesh_kind)
    want = reference_param_specs(arch, mesh, cfg)
    got = tsh.param_specs(mesh, tbuild(cfg, "meta"), cfg)
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not diff, diff
    # the plan does shard something on every mesh axis for every config
    used = {ax for spec in got.values() for e in spec if e is not None
            for ax in (e if isinstance(e, tuple) else (e,))}
    assert used >= {"data"} and ("model" in used), used


def test_placements_follow_the_spec():
    """``placements_for``: ``Shard(d)`` on each mesh dim that splits dim
    ``d`` (two mesh dims on one tensor dim both shard it), else
    ``Replicate``, as on a mesh dim of one rank; ``local_shape`` divides
    accordingly."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 ndim=3, shape=(2, 16, 16))
    spec = (("data", "pod"), "model", None)
    assert tsh.placements_for(mesh, spec) == [Shard(0), Shard(0), Shard(1)]
    assert tsh.placements_for(mesh, (None, None)) == [Replicate()] * 3
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"), ndim=2,
                                shape=(1, 4))
    assert tsh.placements_for(one, ("data", "model")) == [Replicate(),
                                                         Shard(1)]
    assert tsh.local_shape(mesh, spec, (64, 32, 5)) == (2, 2, 5)


def _reference_cache_layers(jcfg, batch, length) -> list:
    """The reference cache's leaves as one {name: shape} per layer, in
    the port's layer order (its group caches sliced along the layer
    axis)."""
    model = jbuild(jcfg)
    if jcfg.is_encoder_decoder:
        tree = jax.eval_shape(lambda: model.init_cache(batch, enc_len=length))
        return [{k: v.shape[1:] for k, v in tree["dec"].items()}
                for _ in range(jcfg.dec_layers)]
    tree = jax.eval_shape(lambda: model.init_cache(batch, length))
    prefix, group, n_groups, tail = stack_plan(jcfg)
    layers = [{k: v.shape for k, v in tree["prefix"][f"block{i}"].items()}
              for i in range(len(prefix))]
    for _ in range(n_groups):
        layers += [{k: v.shape[1:]
                    for k, v in tree["groups"][f"block{i}"].items()}
                   for i in range(len(group))]
    layers += [{k: v.shape for k, v in tree["tail"][f"block{i}"].items()}
               for i in range(len(tail))]
    return layers


@pytest.mark.parametrize("mesh_kind", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh_kind):
    """Per layer and leaf, the decode_32k cache's spec equals the
    reference's (its leaf table, its ``_CACHE_RULES``); the batch's
    ``("batch", None, …)`` spec equals its rules' for every SHAPES
    entry."""
    cfg, jcfg = tconfigs.load_arch(arch), jconfigs.load_arch(arch)
    mesh = ns_mesh(mesh_kind)
    batch, length = 128, 32768
    cache = tbuild(cfg, "meta").init_cache(batch, length)
    want = _reference_cache_layers(jcfg, batch, length)
    assert [{k: tuple(v.shape) for k, v in layer.items()}
            for layer in cache] == [{k: tuple(s) for k, s in layer.items()}
                                    for layer in want]
    for layer in cache:
        for name, leaf in layer.items():
            shape = tuple(leaf.shape)
            axes = jsh._CACHE_LEAF_AXES[name]
            axes = axes[:len(shape)] + (None,) * (len(shape) - len(axes))
            assert tsh.cache_spec(mesh, name, shape) == tuple(
                jsh.spec_for(mesh, jsh._CACHE_RULES, axes, shape)), name
    rules = jsh.rules_for(jcfg, mesh)[1]
    for shape_id, s in tconfigs.SHAPES.items():
        for name, (shape, _) in tspecs._batch_shapes(
                cfg, s["kind"], s["seq_len"], s["global_batch"]).items():
            axes = ("batch",) + (None,) * (len(shape) - 1)
            assert tsh.batch_spec(mesh, shape, cfg) == tuple(
                jsh.spec_for(mesh, rules, axes, shape)), (shape_id, name)


def expected_axes(cfg) -> set:
    """Activation axes of the reference's ``shard_act`` call sites that a
    config's training forward passes through."""
    want = {("batch", "seq", "embed"), ("batch", "seq", "vocab")}
    if cfg.attention != "none":
        want.add(("batch", "seq", "q_heads", None))
    if cfg.family != "ssm":
        want.add(("batch", "seq", "mlp"))
    if cfg.num_experts:
        want |= {("tokens", "embed"), ("experts", None, "embed"),
                 ("experts", None, "expert_mlp")}
    if cfg.family == "ssm":
        want.add(("batch", "seq", "heads", None))
    if cfg.is_encoder_decoder:
        want.add(("batch", "kv_seq", "kv_heads", None))
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_act_without_a_rule_is_the_identity(arch):
    """SMOKE logits (or the encoder-decoder's loss) are bit-equal with no
    rule and with an identity rule that records the axes it sees."""
    cfg = tconfigs.load_smoke(arch)
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.is_encoder_decoder:
        batch["audio_feats"] = rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)

    def out():
        with torch.no_grad():
            if cfg.is_encoder_decoder:
                return model.loss(batch)[0]
            return model.logits(batch)[0]

    x = torch.ones(3)
    assert tlayers.shard_act(x, ("batch",)) is x
    plain = out()
    seen = set()

    def rule(t, axes):
        seen.add(tuple(axes))
        return t
    tlayers.set_activation_rule(rule)
    try:
        ruled = out()
    finally:
        tlayers.set_activation_rule(None)
    assert torch.equal(plain, ruled)
    want = expected_axes(cfg)
    assert want <= seen, want - seen


# --- 8 ranks, in a child process ---------------------------------------------

_RANKS = r'''
import dataclasses, json, os, sys
import torch, torch.distributed as dist, torch.multiprocessing as mp

def fresh(cfg, opt_cfg):
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_opt_state
    m = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith((".wq", ".wk")):
                p.mul_(0.25)
    return m, init_opt_state(m.parameters(), opt_cfg)

def err(a, b):
    """max |a − b| in units of b's scale (its largest magnitude, ≥ 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

def main(rank, world, tmp):
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world))
    from repro_torch.configs import load_smoke
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import sharding as sh, train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import (make_loss_and_grads,
                                              make_train_step, replication)
    cfg = dataclasses.replace(load_smoke("granite_3_2b"), dtype="float32")
    opt_cfg = OptConfig(warmup_steps=0, total_steps=10)
    batch = SyntheticLMData(cfg, 16, 8).batch_at(0)
    out = {}

    # both plans: the TP plan (no config: every family but the pure-DP
    # ones, and those on a mesh with "pod") and granite's own pure DP
    # (the full config's ``prefer_pure_dp``, which its SMOKE drops)
    plans = {"tp": None, "dp": dataclasses.replace(cfg, prefer_pure_dp=True)}

    # train: one device, then the 2x4 mesh
    m, opt = fresh(cfg, opt_cfg)
    _, _, g_ref = make_loss_and_grads(m, 2)(batch)
    g_ref = [g.clone() for g in g_ref]
    opt, met = make_train_step(m, opt_cfg, microbatches=2)(opt, batch)
    p_ref = [p.detach().clone() for p in m.parameters()]
    mesh = make_local_mesh((2, 4), ("data", "model"), "cpu")
    for plan, pc in plans.items():
        m2, _ = fresh(cfg, opt_cfg)
        sh.distribute_params(m2, mesh, pc)
        opt2 = init_opt_state(m2.parameters(), opt_cfg)
        sh.install_activation_rules(mesh, pc)
        place = lambda b: sh.distribute_batch(mesh, b, pc)
        with replication(m2):
            _, _, g_sh = make_loss_and_grads(m2, 2, place)(batch)
            g_sh = [g.full_tensor() for g in g_sh]
        opt2, met2 = make_train_step(m2, opt_cfg, microbatches=2,
                                     place_batch=place)(opt2, batch)
        names = [n for n, _ in m2.named_parameters()]
        o = out[plan] = {}
        o["loss"] = [float(met["loss"]), float(met2["loss"].full_tensor())]
        o["grad_err"] = max(err(a, b) for a, b in zip(g_sh, g_ref))
        lr = float(met["lr"])
        worst = 0.0
        for p, want, g in zip(m2.parameters(), p_ref, g_ref):
            got = p.full_tensor()
            d = (got - want).abs()
            noise = g.abs() <= 1e-5 * max(1.0, float(g.abs().max()))
            scale = max(1.0, float(want.abs().max()))
            worst = max(worst,
                        float(torch.where(noise, 0.0, d).max()) / scale)
            assert float(torch.where(noise, d, 0.0).max()) <= \
                2.5 * lr + 1e-5 * scale
        o["param_err"] = worst
        o["placements"] = {n: str(p.placements)
                           for n, p in zip(names, m2.parameters())}
        o["opt_placements"] = str(
            opt2.mu[names.index("blocks.0.mixer.wq")].placements)
        sh.clear_activation_rules()

    # decode: prefill 8 tokens + 1 step, the cache on a 1x8 mesh
    m, _ = fresh(cfg, opt_cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    lp, cache = m.prefill({"tokens": tokens}, m.init_cache(2, 16))
    ld, _ = m.decode_step(cache, tokens[:, -1:], 8)
    mesh = make_local_mesh((1, 8), ("data", "model"), "cpu")
    for plan, pc in plans.items():
        m3, _ = fresh(cfg, opt_cfg)
        sh.distribute_params(m3, mesh, pc)
        sh.install_activation_rules(mesh, pc)
        c = sh.distribute_cache(mesh, m3.init_cache(2, 16))
        tk = sh.distribute_batch(mesh, {"tokens": tokens}, pc)["tokens"]
        with replication(m3):
            lp2, c = m3.prefill({"tokens": tk}, c)
            ld2, c = m3.decode_step(c, tk[:, -1:], 8)
            lp2, ld2 = lp2.full_tensor(), ld2.full_tensor()
            k_full = c[0]["k"].full_tensor()
        o = out[plan]
        o["prefill_err"], o["decode_err"] = err(lp2, lp), err(ld2, ld)
        o["tokens_equal"] = bool(torch.equal(ld2.argmax(-1), ld.argmax(-1)))
        o["cache_err"] = err(k_full, cache[0]["k"])
        o["cache_placements"] = str(c[0]["k"].placements)
        sh.clear_activation_rules()

    # the launcher on its local ("data",) mesh over the 8 ranks
    args = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--global-batch", "8",
            "--log-every", "100"]
    got = train_cli.run(args)
    out["launcher"] = [r["loss"] for r in got["records"]]
    out["launcher_placement"] = str(next(got["model"].parameters())
                                    .placements)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)

if __name__ == "__main__":
    mp.spawn(main, args=(8, sys.argv[1]), nprocs=8)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    script = os.path.join(tmp, "ranks.py")    # spawn re-imports its main
    with open(script, "w") as f:
        f.write(_RANKS)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    run = subprocess.run([sys.executable, script, tmp], env=env,
                         capture_output=True, text=True, timeout=170)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(os.path.join(tmp, "out.json")) as f:
        return json.load(f)


# the parameter wq and its optimizer state on the 2x4 mesh: TP on heads
# over "model" and FSDP on embed over "data", or pure DP's FSDP alone
WQ = {"tp": "(Shard(dim=0), Shard(dim=1))", "dp": "(Shard(dim=0), Replicate())"}


@pytest.mark.parametrize("plan", ("tp", "dp"))
def test_sharded_train_step_matches_one_device(ranks, plan):
    r = ranks[plan]
    want, got = r["loss"]
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    assert r["grad_err"] <= 1e-5
    assert r["param_err"] <= 1e-5
    # the optimizer state keeps its parameter's placements
    assert r["placements"]["blocks.0.mixer.wq"] == WQ[plan]
    assert r["opt_placements"] == WQ[plan]


@pytest.mark.parametrize("plan", ("tp", "dp"))
def test_sharded_decode_matches_one_device(ranks, plan):
    r = ranks[plan]
    assert r["prefill_err"] <= 1e-5
    assert r["decode_err"] <= 1e-5
    assert r["tokens_equal"]
    assert r["cache_err"] <= 1e-5
    # the cache's sequence dim over "model" (flash-decoding SP) in both
    # plans (the reference's cache rules take no config); "data" has one
    # rank here
    assert r["cache_placements"] == "(Replicate(), Shard(dim=1))"


def test_launcher_trains_on_the_local_mesh(ranks):
    """8 ranks on ``("data",)``: the launcher's losses are the
    one-device launcher's (float32 SMOKE is bf16 here: 2e-2)."""
    from repro_torch.launch import train as train_cli
    want = train_cli.run(["--arch", "granite_3_2b", "--smoke", "--device",
                          "cpu", "--steps", "2", "--seq-len", "16",
                          "--global-batch", "8", "--log-every", "100"])
    want = [r["loss"] for r in want["records"]]
    np.testing.assert_allclose(ranks["launcher"], want, rtol=2e-2)
    assert ranks["launcher_placement"] == "(Shard(dim=1),)"
