"""PyTorch port: every model family's sharded steps, held to one device.

``tests/test_torch_launch.py`` holds granite's sharded steps; this file
holds the other families' on the same meshes and by the same rules:
recurrentgemma_2b (RG-LRU), mamba2_13b (SSD), whisper_large_v3 (with
``audio_feats``), gemma3_27b, internvl2_1b (with ``patches``),
deepseek_v2_236b and deepseek_v3_671b (MLA, the dense prefix, the
expert-parallel MoE; V3 with ``labels_mtp`` through its MTP head).

One child process spawns 8 gloo ranks over a ``FileStore`` under
``tmp_path`` (no process group ever lives in a test worker: the
``no_process_group`` fixture checks) and writes one JSON file; each case
below reads its part of it.  Every family runs at SMOKE in float32 on
weights that ``test_torch_models.reference_params`` draws here in the JAX
package's layout, with ``wq``/``wk``/``w_uq`` at a quarter of the init
scale (the whole-model convention of ``test_torch_models.py``); the
children load them with ``convert.load_reference_params``.

* **The reference:** while the ranks run, the JAX package runs each
  family on the same weights and batch here: the one-device step that
  every mesh run is held to has its loss and gradient norm within 1e-5
  of scale, and for DeepSeek each MoE call keeps and drops the
  reference's assignments at both capacity factors.

* **Train:** one 2-microbatch step (``make_loss_and_grads`` then
  ``apply_updates``, the two halves of ``make_train_step``) on a 2×4
  ``("data", "model")`` mesh against one device: loss, gradients and
  updated parameters within 1e-5 of scale, where a gradient element
  under the rounding noise (≤ 1e-5 of its leaf's scale) lets Adam's
  sign-like first step go either way (2.5 · lr; ``test_torch_launch.py``'s
  rule).
* **Decode:** prefill + 2 greedy steps on a 1×8 mesh, the cache placed by
  ``cache_sharding_tree``: logits within 1e-5 of scale, tokens equal.
* **DeepSeek** runs under the TP/EP plan and under pure DP
  (``prefer_pure_dp``).  Under TP/EP its routed experts are
  ``Shard(dim=0)`` on ``"model"`` and each rank's expert buffer holds
  ``E / 4`` of them; under pure DP they are whole on every rank.  The
  kept and dropped assignments of every MoE call equal one device's at
  SMOKE's own capacity factor (where assignments drop) and at 100 (where
  none do).  Every collective of the expert-parallel ops, forward and
  backward, is counted (``Sent``, a dispatch mode over DTensor's
  functional collectives) and equals ``sharding.ep_bytes``.
* **The launcher** trains deepseek_v2_236b SMOKE (bfloat16) on its local
  ``("data",)`` mesh of the 8 ranks, with losses equal to the one-device
  launcher's within 2e-2.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.train import train_loop as jloop
from test_torch_models import reference_params

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

DENSE = ("recurrentgemma_2b", "mamba2_13b", "whisper_large_v3",
         "gemma3_27b", "internvl2_1b")
MOE = ("deepseek_v2_236b", "deepseek_v3_671b")
CASES = [(a, "tp") for a in DENSE] + [(a, p) for a in MOE
                                      for p in ("tp", "dp")]
TOL = 1e-5


def run_ranks(script: str, tmp: str, timeout: int, *args,
              meanwhile=lambda: None) -> dict:
    """Run ``script`` (which spawns the ranks and has rank 0 write
    ``out.json`` into the directory it is given) in a child process, and
    ``meanwhile()`` here while it runs → that JSON."""
    path = os.path.join(tmp, "ranks.py")     # spawn re-imports its main
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    run = subprocess.Popen([sys.executable, "-W", "ignore", path, tmp, *args],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        meanwhile()
        _, err = run.communicate(timeout=timeout)
    finally:
        if run.poll() is None:
            run.kill()
            run.communicate()
    assert run.returncode == 0, err[-4000:]
    with open(os.path.join(tmp, "out.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def no_process_group():
    yield
    assert not torch.distributed.is_initialized()


_RANKS = r'''
import dataclasses, json, os, sys
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

DENSE = ("recurrentgemma_2b", "mamba2_13b", "whisper_large_v3",
         "gemma3_27b", "internvl2_1b")
MOE = ("deepseek_v2_236b", "deepseek_v3_671b")
STEPS = 2

TMP = sys.argv[1]

def fresh(arch, cfg):
    """A one-device model of ``cfg`` holding the parent's reference
    weights for ``arch`` (``test_torch_models.reference_params``, the JAX
    package's layout, with ``wq``/``wk``/``w_uq`` at a quarter)."""
    from repro_torch.models import build_model, convert
    tree = {}
    with np.load(os.path.join(TMP, arch + ".npz")) as f:
        for key in f.files:
            *path, leaf = key.split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return convert.load_reference_params(build_model(cfg, "cpu"), tree)

def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x

def err(a, b):
    """max |a - b| in units of b's scale (its largest magnitude, >= 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

def train_step(m, opt_cfg, batch, place=None):
    """One 2-microbatch step: (loss, whole gradients, lr)."""
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.train_loop import make_loss_and_grads, replication
    opt = init_opt_state(m.parameters(), opt_cfg)
    with replication(m):
        loss, _, grads = make_loss_and_grads(m, 2, place)(batch)
        _, met = apply_updates(opt_cfg, list(m.parameters()), grads, opt)
        return (float(whole(loss)), [whole(g) for g in grads],
                float(met["lr"]))

def greedy(m, prompt, cache, pos0, place=lambda c: c):
    """Prefill, then STEPS greedy steps, the cache re-placed by ``place``
    after each call: (whole logits, tokens, the last cache)."""
    from repro_torch.train.train_loop import replication
    logits, toks = [], []
    with replication(m):
        lg, cache = m.prefill(prompt, cache)
        for i in range(STEPS):
            logits.append(whole(lg))
            nxt = lg[:, -1:].argmax(-1)
            toks.append(whole(nxt))
            lg, cache = m.decode_step(place(cache), nxt, pos0 + i)
        cache = place(cache)
        logits.append(whole(lg))
    return logits, toks, cache

def routing(m, batch, place=None):
    """Each MoE call's kept assignments (expert-sorted order) and its
    buffer's local experts, in one forward of the loss."""
    from repro_torch.models import moe
    from repro_torch.train.train_loop import replication
    seen, plain = [], moe.expert_buffers
    def spy(xf, route):
        out = plain(xf, route)
        seen.append((route.keep.clone(), (out.to_local() if hasattr(
            out, "to_local") else out).shape[0]))
        return out
    moe.expert_buffers = spy
    try:
        with torch.no_grad(), replication(m):
            m.loss(place(batch) if place else batch)
    finally:
        moe.expert_buffers = plain
    return seen

class Sent(TorchDispatchMode):
    """The bytes this rank sends in the collectives that run under it
    (DTensor's functional collectives; any other makes the count NaN), a
    ring's count: an all-reduce over n ranks 2(n-1)/n of its tensor, an
    all-gather n-1 times its input, a reduce-scatter or an all-to-all
    (n-1)/n of its input; ``ops`` names each."""
    SENDS = {"all_reduce": lambda n: 2 * (n - 1) / n,
             "all_gather_into_tensor": lambda n: n - 1,
             "reduce_scatter_tensor": lambda n: (n - 1) / n,
             "all_to_all_single": lambda n: (n - 1) / n}

    def __init__(self, mesh):
        super().__init__()
        self.n = {mesh.get_group(i).group_name: mesh.size(i)
                  for i in range(mesh.ndim)}
        self.sent, self.ops = 0.0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor make its comms
        if func.namespace in ("_c10d_functional", "c10d_functional", "c10d"):
            name = func._overloadpacket.__name__
            if name in ("wait_tensor", "_wrap_tensor_autograd"):
                return func(*args, **(kwargs or {}))    # not collectives
            self.ops.append(name)
            group = next((self.n[a] for a in args
                          if isinstance(a, str) and a in self.n), None)
            if name not in self.SENDS or group is None:
                self.sent = float("nan")       # a collective not reckoned
            else:
                x = args[0]
                self.sent += (self.SENDS[name](group) * x.numel() *
                              x.element_size())
        return func(*args, **(kwargs or {}))

def ep_sent(mesh, cfg, t):
    """One MoE call of ``t`` tokens through the expert-parallel ops on
    ``mesh`` under :class:`Sent`: the expert ids gathered (``whole``),
    the buffers filled, a local stand-in for the expert GEMMs, the rows
    combined; then the backward pass and one sum of each ``Partial``
    gradient the ops hand back (the token rows', the weights' and the
    expert outputs'), to the placements of what they are gradients of.
    -> (forward bytes, train bytes, the collectives' names)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers as L, moe
    e, k, d = cfg.num_experts, cfg.top_k, cfg.d_model
    rules = sh.rules_for(cfg, mesh)[1]
    tok = sh.placements_for(mesh, sh.spec_for(mesh, rules,
                                              ("tokens", "embed"), (t, d)))
    g = torch.Generator().manual_seed(3)
    probs = torch.randn(t, e, generator=g).softmax(-1)
    topw, tope = moe.top_k(probs, k)
    xf = distribute_tensor(torch.randn(t, d, generator=g), mesh, tok,
                           src_data_rank=None).requires_grad_()
    topw = distribute_tensor(topw, mesh, tok,
                             src_data_rank=None).requires_grad_()
    tope = distribute_tensor(tope, mesh, tok, src_data_rank=None)
    sh.install_activation_rules(mesh, cfg)
    grads = []
    try:
        with Sent(mesh) as fwd:
            flat_e = L.whole(tope).reshape(-1)
            counts = torch.bincount(flat_e, minlength=e)
            route = moe.plan(flat_e, counts, moe.capacity(cfg, t), k)
            out_buf = moe.expert_buffers(xf, route) * 2.0
            out_buf.register_hook(grads.append)
            yf = moe.expert_combine(out_buf, topw, route)
        with Sent(mesh) as bwd:
            (yf.to_local() * torch.randn(yf.to_local().shape,
                                         generator=g)).sum().backward()
            xf.grad.redistribute(mesh, xf.placements)
            topw.grad.redistribute(mesh, topw.placements)
            grads[0].redistribute(mesh, out_buf.placements)
    finally:
        sh.clear_activation_rules()
    return fwd.sent, fwd.sent + bwd.sent, fwd.ops + bwd.ops

def main(rank, world, tmp):
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world))
    from repro_torch.configs import load_smoke
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import sharding as sh, train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optimizer import OptConfig
    opt_cfg = OptConfig(warmup_steps=0, total_steps=10)
    mesh24 = make_local_mesh((2, 4), ("data", "model"), "cpu")
    mesh18 = make_local_mesh((1, 8), ("data", "model"), "cpu")
    out = {}
    for arch in DENSE + MOE:
        cfg = dataclasses.replace(load_smoke(arch), dtype="float32")
        plans = {"tp": None}
        if cfg.num_experts:
            plans["dp"] = dataclasses.replace(cfg, prefer_pure_dp=True)
        batch = SyntheticLMData(cfg, 16, 8).batch_at(0)

        # train: one device, then the 2x4 mesh under each plan
        m = fresh(arch, cfg)
        loss, g_ref, lr = train_step(m, opt_cfg, batch)
        p_ref = [p.detach() for p in m.parameters()]
        res = out[arch] = {p: {} for p in plans}
        # the one-device step the mesh is held to, held to the JAX package
        res["one_device"] = {"loss": loss, "grad_norm": float(torch.sqrt(
            sum((g.double() ** 2).sum() for g in g_ref)))}
        for plan, pc in plans.items():
            m2 = sh.distribute_params(fresh(arch, cfg), mesh24, pc)
            sh.install_activation_rules(mesh24, pc)
            loss2, g2, _ = train_step(
                m2, opt_cfg, batch,
                lambda b, pc=pc: sh.distribute_batch(mesh24, b, pc))
            o = res[plan]
            o["loss"] = [loss, loss2]
            o["grad_err"] = max(err(a, b) for a, b in zip(g2, g_ref))
            worst = 0.0
            for p, want, g in zip(m2.parameters(), p_ref, g_ref):
                d = (whole(p).detach() - want).abs()
                noise = g.abs() <= 1e-5 * max(1.0, float(g.abs().max()))
                scale = max(1.0, float(want.abs().max()))
                worst = max(worst,
                            float(torch.where(noise, 0.0, d).max()) / scale)
                assert float(torch.where(noise, d, 0.0).max()) <= \
                    2.5 * lr + 1e-5 * scale
            o["param_err"] = worst
            if cfg.num_experts:
                o["experts"] = {n: str(p.placements)
                                for n, p in m2.named_parameters()
                                if ".ffn." in n and p.dim() == 3}
            sh.clear_activation_rules()

        # the MoE's routing on the 2x4 mesh against one device
        if cfg.num_experts:
            for cf in (cfg.capacity_factor, 100.0):
                c = dataclasses.replace(cfg, capacity_factor=cf)
                want = routing(fresh(arch, c), batch)
                res["one_device"][f"keep_{cf:g}"] = [
                    a[0].tolist() for a in want]
                for plan, pc in plans.items():
                    pc = c if pc is None else dataclasses.replace(
                        c, prefer_pure_dp=True)
                    m2 = sh.distribute_params(fresh(arch, c), mesh24, pc)
                    sh.install_activation_rules(mesh24, pc)
                    got = routing(
                        m2, batch, lambda b: sh.distribute_batch(mesh24, b, pc))
                    sh.clear_activation_rules()
                    fwd, train, ops = ep_sent(mesh24, pc, 8 * 16)
                    ep = sh.ep_bytes(mesh24, pc, 8 * 16)
                    res[plan][f"routing_{cf:g}"] = {
                        "calls": [len(got), len(want)],
                        "equal": all(torch.equal(a[0], b[0])
                                     for a, b in zip(got, want)),
                        "dropped": [int((~a[0]).sum()) for a in want],
                        "local_experts": sorted({a[1] for a in got}),
                        "sent": [[fwd, ep["forward"]],
                                 [train, ep["train"]]],
                        "ops": sorted(set(ops))}

        # decode: prefill 8 tokens (+ patches, + audio) and STEPS steps on
        # the 1x8 mesh
        prompt = {"tokens": torch.randint(
            0, cfg.vocab_size, (2, 8),
            generator=torch.Generator().manual_seed(1))}
        extra = SyntheticLMData(cfg, 16, 2).batch_at(5)
        for k in ("audio_feats", "patches"):
            if k in extra:
                prompt[k] = torch.as_tensor(extra[k])
        pos0 = 8 + (cfg.num_patches or 0)
        # the cache's length (whisper's: its 16 frames) a multiple of 8, so
        # that its sequence splits over "model"
        length = 16 if cfg.is_encoder_decoder else -(-(pos0 + STEPS) // 8) * 8
        m = fresh(arch, cfg)
        lw, tw, _ = greedy(m, dict(prompt), m.init_cache(2, length), pos0)
        for plan, pc in plans.items():
            m3 = sh.distribute_params(fresh(arch, cfg), mesh18, pc)
            sh.install_activation_rules(mesh18, pc)
            lg, tg, cache = greedy(
                m3, sh.distribute_batch(mesh18, prompt, pc),
                sh.distribute_cache(mesh18, m3.init_cache(2, length)), pos0,
                lambda c: sh.distribute_cache(mesh18, c))
            o = res[plan]
            o["logits_err"] = max(err(a, b) for a, b in zip(lg, lw))
            o["tokens_equal"] = all(torch.equal(a, b) for a, b in zip(tg, tw))
            o["cache_placements"] = [
                {k: str(v.placements) for k, v in layer.items()}
                for layer in cache]
            o["cache_spec"] = [
                {k: str(tuple(v)) for k, v in layer.items()}
                for layer in sh.cache_sharding_tree(mesh18, cache)]
            sh.clear_activation_rules()

    # the launcher on its local ("data",) mesh over the 8 ranks
    got = train_cli.run(["--arch", "deepseek_v2_236b", "--smoke", "--device",
                         "cpu", "--steps", "2", "--seq-len", "16",
                         "--global-batch", "8", "--log-every", "100"])
    out["launcher"] = [r["loss"] for r in got["records"]]
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)

if __name__ == "__main__":
    mp.spawn(main, args=(8, sys.argv[1]), nprocs=8)
'''


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_keeps(jc, params, batch) -> list:
    """Each MoE call's kept assignments (expert-sorted order) in the JAX
    package's loss on ``batch``, run op by op: the rows that
    ``repro.models.moe.moe_ffn`` fills its buffers with (its first
    ``("tokens", "embed")`` annotation of three a call) are nonzero
    exactly where kept."""
    from repro.models import moe as jmoe
    seen, plain = [], jmoe.shard_act

    def spy(x, axes):
        if tuple(axes) == ("tokens", "embed"):
            seen.append(np.asarray(x))
        return plain(x, axes)
    jmoe.shard_act = spy
    try:
        with jax.disable_jit():
            jbuild(jc).loss(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    finally:
        jmoe.shard_act = plain
    assert seen and len(seen) % 3 == 0
    return [rows.any(-1).tolist() for rows in seen[0::3]]


def jax_run(jc, params) -> dict:
    """The JAX package on the child's batch and the same weights: the
    2-microbatch loss and the gradients' norm, and (MoE) each call's kept
    assignments at SMOKE's capacity factor and at 100."""
    from repro_torch.data.pipeline import SyntheticLMData
    batch = SyntheticLMData(jc, 16, 8).batch_at(0)
    loss, _, grads = jax.jit(jloop.make_loss_and_grads(jbuild(jc), 2))(
        params, batch)
    out = {"loss": float(loss), "grad_norm": float(np.sqrt(sum(
        np.sum(np.asarray(g, np.float64) ** 2)
        for g in jax.tree.leaves(grads))))}
    if jc.num_experts:
        for cf in (jc.capacity_factor, 100.0):
            out[f"keep_{cf:g}"] = jax_keeps(
                dataclasses.replace(jc, capacity_factor=cf), params, batch)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The child's JSON, and under ``"jax"`` the JAX package's run of each
    family on the weights the child loads (drawn here by
    ``test_torch_models.reference_params``, ``wq``/``wk``/``w_uq`` at a
    quarter), computed while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("families"))
    drawn, ref = {}, {}
    for arch in DENSE + MOE:
        jc = dataclasses.replace(jconfigs.load_smoke(arch), dtype="float32")
        drawn[arch] = jc, reference_params(jc, qk_scale=0.25)
        np.savez(os.path.join(tmp, arch + ".npz"), **_flat(drawn[arch][1]))

    def meanwhile():
        for arch, (jc, params) in drawn.items():
            ref[arch] = jax_run(jc, params)
    # ~185 s alone, ~520 s beside five other pytest workers
    out = run_ranks(_RANKS, tmp, 1200, meanwhile=meanwhile)
    out["jax"] = ref
    return out


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_one_device_step_matches_the_reference(ranks, arch):
    """The one-device step that every mesh run below is held to computes
    the JAX package's loss and gradient norm on the same weights and
    batch (float32: 1e-5 of scale)."""
    got, want = ranks[arch]["one_device"], ranks["jax"][arch]
    assert abs(got["loss"] - want["loss"]) <= TOL * max(1.0,
                                                        abs(want["loss"]))
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=TOL)


@pytest.mark.parametrize("cf", ("1.25", "100"))
@pytest.mark.parametrize("arch", MOE)
def test_one_device_routing_matches_the_reference(ranks, arch, cf):
    """One device keeps and drops exactly the assignments the JAX package
    does, call by call (and the mesh keeps one device's:
    ``test_routing_equals_one_device``)."""
    got = ranks[arch]["one_device"][f"keep_{cf}"]
    want = ranks["jax"][arch][f"keep_{cf}"]
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("arch,plan", CASES)
def test_sharded_train_step_matches_one_device(ranks, arch, plan):
    r = ranks[arch][plan]
    want, got = r["loss"]
    assert abs(got - want) <= TOL * max(1.0, abs(want))
    assert r["grad_err"] <= TOL
    assert r["param_err"] <= TOL


@pytest.mark.parametrize("arch,plan", CASES)
def test_sharded_decode_matches_one_device(ranks, arch, plan):
    r = ranks[arch][plan]
    assert r["logits_err"] <= TOL
    assert r["tokens_equal"]
    # every cache leaf kept on cache_sharding_tree's placements, some of
    # them split over "model" (the KV sequence: flash-decoding SP; states'
    # heads or width)
    assert r["cache_placements"] == r["cache_spec"]
    assert any("Shard" in p for layer in r["cache_placements"]
               for p in layer.values())


# the routed experts on the 2x4 mesh: FSDP on embed over "data" (dim 1 of
# gate/up, dim 2 of down), and under TP/EP the experts over "model"
EXPERTS = {"tp": {"gate": "(Shard(dim=1), Shard(dim=0))",
                  "up": "(Shard(dim=1), Shard(dim=0))",
                  "down": "(Shard(dim=2), Shard(dim=0))"},
           "dp": {"gate": "(Shard(dim=1), Replicate())",
                  "up": "(Shard(dim=1), Replicate())",
                  "down": "(Shard(dim=2), Replicate())"}}


@pytest.mark.parametrize("plan", ("tp", "dp"))
@pytest.mark.parametrize("arch", MOE)
def test_experts_split_over_model(ranks, arch, plan):
    from repro_torch.configs import load_smoke
    r = ranks[arch][plan]
    assert r["experts"]
    for name, placements in r["experts"].items():
        assert placements == EXPERTS[plan][name.rpartition(".")[2]], name
    e = load_smoke(arch).num_experts
    assert r["routing_1.25"]["local_experts"] == [e // 4 if plan == "tp"
                                                  else e]


@pytest.mark.parametrize("cf", ("1.25", "100"))
@pytest.mark.parametrize("plan", ("tp", "dp"))
@pytest.mark.parametrize("arch", MOE)
def test_routing_equals_one_device(ranks, arch, plan, cf):
    r = ranks[arch][plan][f"routing_{cf}"]
    got, want = r["calls"]
    assert got == want > 0
    assert r["equal"]
    # every collective of the expert-parallel ops (``ep_sent``: the
    # routing gather and the sums forward; backward, the sums of the
    # Partial gradients they hand back) sends what ``sharding.ep_bytes``
    # reckons
    (fwd, fwd_reckoned), (train, train_reckoned) = r["sent"]
    assert fwd == pytest.approx(fwd_reckoned, rel=1e-12) and fwd > 0
    assert train == pytest.approx(train_reckoned, rel=1e-12) and train > fwd
    assert set(r["ops"]) == {"all_gather_into_tensor", "all_reduce"}
    if cf == "100":
        assert not any(r["dropped"])
    else:                 # SMOKE's own capacity factor drops assignments
        assert any(r["dropped"])


def test_launcher_trains_deepseek_on_the_local_mesh(ranks):
    """8 ranks on ``("data",)``: the launcher's losses are the
    one-device launcher's (SMOKE is bfloat16: 2e-2)."""
    from repro_torch.launch import train as train_cli
    want = train_cli.run(["--arch", "deepseek_v2_236b", "--smoke", "--device",
                          "cpu", "--steps", "2", "--seq-len", "16",
                          "--global-batch", "8", "--log-every", "100"])
    want = [r["loss"] for r in want["records"]]
    np.testing.assert_allclose(ranks["launcher"], want, rtol=2e-2)
