"""PyTorch port: checkpoints saved from a mesh and restored onto one.

One child process spawns 8 gloo ranks over a ``FileStore`` under
``tmp_path`` (``test_torch_mesh_families.run_ranks``) and writes one JSON
file; the cases below read it, and the last one reads a checkpoint the
ranks wrote with the JAX package.  The state is deepseek_v2_236b SMOKE
(bfloat16 parameters, float32 moments and master copies; its dense
prefix, stacked MoE groups and split experts), one train step in so that
every leaf is nonzero:

* **Mesh → one device:** saved from the 2×4 ``("data", "model")`` mesh
  (every rank makes each leaf whole, rank 0 writes) and restored on one
  device, every leaf equals the sharded leaf's ``full_tensor()`` bit for
  bit.
* **One device → mesh:** saved from one device and restored onto the 8
  ranks through ``elastic_restore``: every parameter and optimizer leaf
  lies on ``param_sharding_tree``'s placements, and its whole value is
  the saved one's.
* **Mesh → mesh:** saved from the 2×4 mesh and restored onto a 1×8 mesh,
  each rank's host bytes traced: a restore reads only a rank's own
  block of one part at a time, so no rank's host holds the whole state;
  a rank's block of a leaf is its DTensor shard.
* **The launcher** (granite_3_2b SMOKE, 8 ranks on its ``("data",)``
  mesh, ``--ckpt-dir``) is preempted at step 2 by ``guard.trigger()`` on
  rank 3 alone: every rank stops there and checkpoints, the same command
  resumes at step 3, and the losses equal the uninterrupted run's.
* **The JAX package** (``repro.train.checkpoint.restore``) reads the
  mesh-written checkpoint, equal to the port's leaves.
"""

import os

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import load_smoke
from repro_torch.models import build_model, convert
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state
from test_torch_mesh_families import no_process_group, run_ranks  # noqa: F401
from test_torch_models import reference_params, to_np

ARCH = "deepseek_v2_236b"

_RANKS = r'''
import dataclasses, json, os, sys, tracemalloc
import torch, torch.distributed as dist, torch.multiprocessing as mp

ARCH = "deepseek_v2_236b"

def fresh(cfg, seed):
    from repro_torch.models import build_model
    return build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))

def leaves(m, opt):
    """Every leaf of the state, whole, in a fixed order."""
    w = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return ([w(p).detach() for p in m.parameters()] + [w(opt.step)] +
            [w(t) for t in list(opt.mu) + list(opt.nu) + list(opt.master)])

def same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))

def stepped(m, opt_cfg, batch, place=None):
    """(model, optimizer state) one train step in."""
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import make_train_step
    opt = init_opt_state(m.parameters(), opt_cfg)
    opt, _ = make_train_step(m, opt_cfg, place_batch=place)(opt, batch)
    return m, opt

def main(rank, world, tmp):
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world))
    from repro_torch.configs import load_smoke
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import sharding as sh, train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import PreemptionGuard, elastic_restore
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    cfg = load_smoke(ARCH)
    opt_cfg = OptConfig(warmup_steps=0, total_steps=10)
    batch = SyntheticLMData(cfg, 16, 8).batch_at(0)
    mesh24 = make_local_mesh((2, 4), ("data", "model"), "cpu")
    mesh18 = make_local_mesh((1, 8), ("data", "model"), "cpu")
    out = {}

    def on(mesh, seed):
        """A fresh model of seed ``seed`` on ``mesh``, rules installed."""
        m = sh.distribute_params(fresh(cfg, seed), mesh, cfg)
        sh.install_activation_rules(mesh, cfg)
        return m

    # saved from the 2x4 mesh ...
    m, opt = stepped(on(mesh24, 0), opt_cfg, batch,
                     lambda b: sh.distribute_batch(mesh24, b, cfg))
    ckpt.save(os.path.join(tmp, "mesh"), 1, {"params": m, "opt": opt})
    want = leaves(m, opt)
    sh.clear_activation_rules()
    # ... restored on one device
    m1 = fresh(cfg, 7)
    state = ckpt.restore(os.path.join(tmp, "mesh"), 1, {
        "params": m1, "opt": init_opt_state(m1.parameters(), opt_cfg)})
    got = leaves(state["params"], state["opt"])
    n = len(list(m1.parameters()))
    out["mesh_to_one"] = {"params": same(got[:n], want[:n]),
                          "opt": same(got[n:], want[n:]),
                          "leaves": len(got)}
    # ... and onto a 1x8 mesh
    m8 = on(mesh18, 7)
    state = ckpt.restore(os.path.join(tmp, "mesh"), 1, {
        "params": m8, "opt": init_opt_state(m8.parameters(), opt_cfg)})
    out["mesh_to_mesh"] = same(leaves(state["params"], state["opt"]), want)
    sh.clear_activation_rules()

    # the host's bytes in a mesh restore, traced (numpy's buffers and
    # Python's objects), at a vocabulary of 32,768 so that the state (32
    # MB) dwarfs the interpreter's own allocations: a rank reads its own
    # block of one part at a time, so its peak is about its largest
    # block, far below the whole state
    big = dataclasses.replace(cfg, vocab_size=32768)
    m = sh.distribute_params(fresh(big, 0), mesh24, big)
    ckpt.save(os.path.join(tmp, "big"), 0, {
        "params": m, "opt": init_opt_state(m.parameters(), opt_cfg)})
    m = sh.distribute_params(fresh(big, 7), mesh18, big)
    like = {"params": m, "opt": init_opt_state(m.parameters(), opt_cfg)}
    ts = list(m.parameters()) + [like["opt"].step] + [
        t for g in like["opt"][1:] for t in g]
    local = [t.to_local() if hasattr(t, "to_local") else t for t in ts]
    tracemalloc.start()
    ckpt.restore(os.path.join(tmp, "big"), 0, like)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    mine = [peak, max(t.numel() * t.element_size() for t in local),
            sum(t.numel() * t.element_size() for t in ts)]
    out["restore_bytes"] = [None] * world
    dist.all_gather_object(out["restore_bytes"], mine)

    # a rank's block of a leaf is its DTensor shard (torch.chunk's split,
    # uneven sizes and a dim split over both mesh dims among them)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    blocks = []
    for mesh in (mesh24, mesh18):
        for shape, placements in (
                ((5, 7), (Shard(0), Shard(1))), ((3, 10), (Shard(1), Shard(1))),
                ((9, 2, 3), (Replicate(), Shard(0))), ((), (Replicate(),) * 2),
                ((6,), (Shard(0), Shard(0)))):
            t = torch.arange(max(1, int(torch.tensor(shape).prod())),
                             dtype=torch.float32).reshape(shape)
            d = distribute_tensor(t, mesh, placements, src_data_rank=None)
            blocks.append(torch.equal(t[ckpt._block(shape, d)], d.to_local()))
    out["blocks"] = [None] * world
    dist.all_gather_object(out["blocks"], blocks)

    # saved from one device (rank 0 writes; every rank steps the same) ...
    m0, opt0 = stepped(fresh(cfg, 0), opt_cfg, batch)
    if rank == 0:
        ckpt.save(os.path.join(tmp, "one"), 1, {"params": m0, "opt": opt0})
    dist.barrier()
    # ... restored onto the 8 ranks
    m = on(mesh24, 7)
    state, at = elastic_restore(os.path.join(tmp, "one"), {
        "params": m, "opt": init_opt_state(m.parameters(), opt_cfg)})
    sh.clear_activation_rules()
    names = [k for k, _ in m.named_parameters()]
    tree = {k: str(tuple(v)) for k, v in
            sh.param_sharding_tree(mesh24, m, cfg).items()}
    o = state["opt"]
    out["one_to_mesh"] = {
        "step": at,
        "equal": same(leaves(state["params"], o), leaves(m0, opt0)),
        "params": [str(p.placements) == tree[k]
                   for k, p in zip(names, m.parameters())],
        "opt": [str(t.placements) == tree[k]
                for group in (o.mu, o.nu, o.master)
                for k, t in zip(names, group)],
        "sharded": sum("Shard" in v for v in tree.values())}

    # the launcher, preempted at step 2 by rank 3 alone, then resumed
    args = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
            "--steps", "4", "--seq-len", "16", "--global-batch", "8",
            "--log-every", "100"]

    class StopAt2OnRank3(PreemptionGuard):
        polls = 0

        @property
        def should_stop(self):
            if rank == 3 and self.polls == 2:
                self.trigger()
            self.polls += 1
            return super().should_stop

    train_cli.PreemptionGuard = StopAt2OnRank3
    first = train_cli.run(args + ["--ckpt-dir", os.path.join(tmp, "run")])
    train_cli.PreemptionGuard = PreemptionGuard
    second = train_cli.run(args + ["--ckpt-dir", os.path.join(tmp, "run")])
    whole = train_cli.run(args)
    stopped = [None] * world
    dist.all_gather_object(stopped, [r["step"] for r in first["records"]])
    out["launcher"] = {
        "stopped": stopped,
        "committed": ckpt.latest_step(os.path.join(tmp, "run")),
        "resumed": [r["loss"] for r in first["records"] + second["records"]],
        "steps": [r["step"] for r in first["records"] + second["records"]],
        "whole": [r["loss"] for r in whole["records"]]}
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
    tmp = str(tmp_path_factory.mktemp("mesh_ckpt"))
    # ~60 s alone, ~150 s beside five other pytest workers
    return tmp, run_ranks(_RANKS, tmp, 600)


@pytest.mark.parametrize("part", ("params", "opt"))
def test_mesh_checkpoint_restores_on_one_device(ranks, part):
    r = ranks[1]["mesh_to_one"]
    assert r[part]
    # parameters, step, mu, nu, master
    n = len(list(build_model(load_smoke(ARCH), "meta").parameters()))
    assert r["leaves"] == 4 * n + 1


def test_one_device_checkpoint_restores_onto_the_mesh(ranks):
    r = ranks[1]["one_to_mesh"]
    assert r["step"] == 1
    assert r["equal"]
    assert r["params"] and all(r["params"])
    assert len(r["opt"]) == 3 * len(r["params"]) and all(r["opt"])
    assert r["sharded"] > len(r["params"]) // 2


def test_mesh_checkpoint_restores_onto_another_mesh(ranks):
    assert ranks[1]["mesh_to_mesh"]


def test_a_mesh_restore_holds_one_block_on_the_host(ranks):
    """Each rank's traced host bytes (numpy's buffers and Python's
    objects) while it restores a 32 MB state onto the 1x8 mesh peak at
    its largest block plus 1 MiB: never the whole state, which a restore
    that loaded every leaf first would hold."""
    for peak, block, whole in ranks[1]["restore_bytes"]:
        assert peak <= block + 2 ** 20
        assert whole > 4 * (block + 2 ** 20)


def test_a_rank_s_block_is_its_dtensor_shard(ranks):
    assert all(all(r) and len(r) == 10 for r in ranks[1]["blocks"])


def test_launcher_resumes_after_a_one_rank_preemption(ranks):
    r = ranks[1]["launcher"]
    # every rank stopped after step 2, where rank 3 alone was preempted
    assert r["stopped"] == [[0, 1, 2]] * 8
    assert r["committed"] == 3
    assert r["steps"] == [0, 1, 2, 3]
    assert r["resumed"] == r["whole"]


def test_jax_restores_a_mesh_checkpoint(ranks):
    """``repro.train.checkpoint.restore`` reads what the mesh wrote: its
    leaves equal the port's one-device restore of the same files."""
    tmp = os.path.join(ranks[0], "mesh")
    jc = jconfigs.load_smoke(ARCH)
    params = reference_params(jc, seed=4)
    like = {"params": params, "opt": jopt.init_opt_state(
        params, jopt.OptConfig())}
    state = jckpt.restore(tmp, 1, like)
    model = build_model(load_smoke(ARCH), "cpu")
    opt_cfg = OptConfig()
    got = ckpt.restore(tmp, 1, {"params": model, "opt": init_opt_state(
        model.parameters(), opt_cfg)})
    want = {"params": convert.reference_tree(model, model.parameters()),
            "opt": convert.reference_opt_tree(model, got["opt"])}
    for k in ("params", "opt"):
        jl = jax.tree.leaves(state[k])
        tl = jax.tree.leaves(want[k])
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert a.shape == tuple(b.shape)
            assert np.array_equal(to_np(a).astype(np.float64),
                                  b.float().numpy().astype(np.float64))
    assert int(state["opt"][0]) == 1
