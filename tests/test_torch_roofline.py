"""PyTorch port: the roofline's arithmetic and the dry-run.

* ``active_params`` and ``model_flops_for`` equal the JAX package's for
  all ten configs × the four SHAPES entries (pure Python over the same
  config fields).  ``CellCost.linearize`` equals the reference's on the
  same costs; the time terms use the H100 constants.
* The reckoned bytes and collectives follow their docstring on a
  data-only mesh, computed here from the model's own parameters; a
  one-rank mesh moves no collective bytes.  ``count_flops`` counts a
  matmul as 2·m·n·k.
* The dry-run runs in child processes (its fake process group never
  lives in a test worker): granite_3_2b/train_4k on each production mesh,
  the MaskSearch cells, and ``--all --no-cost`` on each mesh.  Every
  cell's status is ``ok`` or the reference's ``skipped``; the counted
  FLOPs of granite's train step, all ranks, are 1.0–2.5× the analytic
  6·N·D (which leaves out attention's S² terms and remat's recompute);
  the records carry the reference's JSON keys (``fits_80g`` in place of
  ``fits_16g``).  Nothing here imports the JAX package's ``dryrun``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from repro import configs as jconfigs
from repro.roofline import extract as jextract
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.roofline import extract as textract
from repro_torch.roofline import report

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(autouse=True)
def no_process_group():
    yield
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = tconfigs.load_arch(arch), jconfigs.load_arch(arch)
    assert textract.active_params(cfg) == jextract.active_params(jcfg)
    for s in tconfigs.SHAPES.values():
        args = (s["kind"], s["seq_len"], s["global_batch"])
        assert textract.model_flops_for(cfg, *args) == \
            jextract.model_flops_for(jcfg, *args)


def test_linearize_and_time_terms():
    counts = {k: 1 for k in textract._COLLECTIVES}
    one = dict(flops=1e12, bytes_accessed=4e9, coll_bytes=1e9,
               coll_counts=counts)
    two = dict(flops=1.5e12, bytes_accessed=5e9, coll_bytes=1.25e9,
               coll_counts={k: 3 for k in counts})
    got = textract.CellCost(**one).linearize(textract.CellCost(**two), 40)
    want = jextract.CellCost(**one).linearize(jextract.CellCost(**two), 40)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    roof = textract.Roofline.from_cost(got, 256, 1e16)
    assert roof.compute_s == got.flops / 989e12
    assert roof.memory_s == got.bytes_accessed / 3.35e12
    assert roof.collective_s == got.coll_bytes / 450e9
    assert roof.dominant == "collective"      # 23.9 ms over 20.7 and 2.9
    assert roof.hlo_flops_global == got.flops * 256
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_count_flops_counts_a_matmul():
    a = torch.zeros((8, 16), device="meta")
    b = torch.zeros((16, 32), device="meta")
    assert textract.count_flops(lambda: a @ b) == 2 * 8 * 16 * 32


def _mesh(**axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=axes)


def test_reckoned_bytes_follow_the_formula():
    """granite SMOKE's train_4k cell: on a 4-way data mesh every weight is
    FSDP-sharded 4 ways and nothing is split on "model", so the gathers
    move 3/4 of the weights twice and the reduce-scatter 3/4 of the
    grads once; on one rank nothing moves."""
    cfg = tconfigs.load_smoke("granite_3_2b")
    model = tspecs.build_model(cfg, "meta")
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    cell = tspecs.build_cell("granite_3_2b", cfg, "train_4k",
                             _mesh(data=4, model=1))
    cost = textract.reckon_cost(cell)
    assert cost.coll_bytes == pytest.approx(2 * 0.75 * w + 0.75 * w)
    assert cost.coll_counts["all-reduce"] == 0
    x = 2 * 256 * 4096 * 4 / 4              # tokens + labels, int32, /4
    opt = n * (4 + 4 + 4) / 4               # mu, nu, master
    assert cost.bytes_accessed == pytest.approx(
        3 * w + 2 * (w / 4 + w / 4 + opt) + x)
    one = textract.reckon_cost(tspecs.build_cell(
        "granite_3_2b", cfg, "train_4k", _mesh(data=1, model=1)))
    assert one.coll_bytes == 0 and one.coll_counts["all-gather"] == 0


# --- the dry-run, in child processes ------------------------------------------

RUNS = {
    "granite_single": ["--arch", "granite_3_2b", "--shape", "train_4k",
                       "--mesh", "single"],
    "granite_multi": ["--arch", "granite_3_2b", "--shape", "train_4k",
                      "--mesh", "multi"],
    "masksearch": ["--masksearch", "--mesh", "single"],
    "all_single": ["--all", "--mesh", "single", "--no-cost"],
    "all_multi": ["--all", "--mesh", "multi", "--no-cost"],
}


def dryrun(args, out: str) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", out], env=env, capture_output=True, text=True,
        timeout=170)
    assert run.returncode == 0, run.stderr[-4000:]
    return run.stdout


def load(out: str, mesh: str, name: str) -> dict:
    with open(os.path.join(out, mesh, name + ".json")) as f:
        return json.load(f)


REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "kind", "n_chips",
                  "lower_s", "compile_s", "memory", "low_mem_opt",
                  "scanned_cost", "model_flops"}
COST_KEYS = {"linearized_cost", "roofline", "n_groups"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_estimate_bytes"}
ROOF_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
             "model_flops", "hlo_flops_global", "useful_ratio"}


@pytest.mark.parametrize("mesh", ("single", "multi"))
def test_dryrun_granite_train(mesh, tmp_path):
    out = str(tmp_path)
    text = dryrun(RUNS[f"granite_{mesh}"], out)
    assert "[OK]" in text
    r = load(out, mesh, "granite_3_2b__train_4k")
    assert r["status"] == "ok" and r["fits_80g"]
    assert r["n_chips"] == (256 if mesh == "single" else 512)
    assert set(r) >= REFERENCE_KEYS | {"fits_80g"}
    assert set(r["memory"]) == MEMORY_KEYS
    cfg = tconfigs.load_arch("granite_3_2b")
    assert r["model_flops"] == textract.model_flops_for(cfg, "train", 4096,
                                                        256)
    if mesh == "multi":             # the reference costs single-pod only
        assert not set(r) & COST_KEYS
        return
    assert set(r) >= COST_KEYS and set(r["roofline"]) == ROOF_KEYS
    glob = r["linearized_cost"]["flops"] * r["n_chips"]
    assert 1.0 <= glob / r["model_flops"] <= 2.5, glob / r["model_flops"]
    assert r["roofline"]["hlo_flops_global"] == pytest.approx(glob)
    assert r["n_groups"] == cfg.num_layers


def test_dryrun_masksearch(tmp_path):
    out = str(tmp_path)
    dryrun(RUNS["masksearch"], out)
    db = tspecs.MS_DB
    for name in ("filter_bounds_4m", "topk_bounds_4m", "verify_64k",
                 "iou_agg_256k"):
        r = load(out, "single", "masksearch__" + name)
        assert r["status"] == "ok", r
        assert set(r) >= {"arch", "shape", "mesh", "note", "n_chips",
                          "memory", "cost", "roofline"}
        assert r["roofline"]["dominant"] == "memory"
    # memory held: every input whole; memory term: what a step reads of
    # them (16 corner sectors of a CHI table, a mean ROI's pixels) and the
    # outputs it writes
    r = load(out, "single", "masksearch__filter_bounds_4m")
    n = db["n_masks"]
    tables = n * 17 ** 3 * 4
    assert r["memory"]["argument_bytes"] == (tables + n * 16) / 256
    assert r["cost"]["bytes_accessed"] == pytest.approx(
        n * (16 * 32 + 16 + 2) / 256)
    r = load(out, "single", "masksearch__verify_64k")
    v = db["verify_batch"]
    assert r["memory"]["argument_bytes"] == v * (256 * 256 * 4 + 16) / 256
    assert r["cost"]["bytes_accessed"] == pytest.approx(
        v * (71.5 ** 2 * 4 + 16 + 4) / 256)


@pytest.mark.parametrize("mesh", ("single", "multi"))
def test_dryrun_places_every_cell(mesh, tmp_path):
    out = str(tmp_path)
    text = dryrun(RUNS[f"all_{mesh}"], out)
    assert "[FAIL]" not in text
    statuses = {}
    for arch in tconfigs.ARCH_IDS:
        for shape in tconfigs.SHAPES:
            r = load(out, mesh, f"{arch}__{shape}")
            statuses[arch, shape] = r["status"]
            ok, _ = tconfigs.load_arch(arch).supports_shape(shape)
            assert r["status"] == ("ok" if ok else "skipped"), r
    assert sum(s == "ok" for s in statuses.values()) == 32
    tables = report.dryrun_table(report.load_results(out, mesh))
    assert tables.count("| ok |") == 32 and "FAIL" not in tables
