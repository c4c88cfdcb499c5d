"""Roofline terms for a dry-run cell, reckoned from its placements.

The port of the JAX package's ``roofline/extract.py``.  The reference
reads FLOPs, bytes and collectives from a compiled XLA program; the port
compiles nothing, so per (arch × shape × mesh) cell:

* **FLOPs** are counted by ``torch.utils.flop_counter.FlopCounterMode``
  over the step run on the ``meta`` device at the cell's global shapes
  (train: forward and backward, remat's recompute included; serving: the
  prefill or one decode step).  Per device = counted ÷ ranks, an even
  split: work that a divisibility fallback replicates is not counted
  twice.
* **Bytes** (the memory term) and **collective bytes** are *reckoned*,
  not measured, from each leaf's per-device shard under its placements
  (``launch/sharding.py``).  With ``P`` the weights a rank computes with
  (each parameter's bytes ÷ its "model"-axis split, i.e. after FSDP's
  all-gather), ``S`` the rank's shards of the parameters, ``O`` of the
  optimizer state (moments, master), ``G`` of the gradients, ``C`` of the
  cache and ``X`` of the batch:

      train    bytes = 3·P + 2·(S + G + O) + X     (fwd, remat fwd, bwd;
                                                    the update reads and
                                                    writes its state)
      prefill  bytes = P + C + X                    (the cache written once)
      decode   bytes = P + C + X                    (the cache read once)
      query    bytes = Σ reads · X_leaf + outputs   (the inputs' bytes the
                                                     step needs: the ROI
                                                     pixels, the CHI
                                                     corners; specs.py)

      all-gather     = passes · Σ (P_leaf − S_leaf)  (FSDP: train gathers
                                                      twice, fwd and bwd;
                                                      serving once)
      reduce-scatter = Σ (P_leaf − S_leaf) in the grad dtype (train)
      all-reduce     = a · L · 2·(m−1)/m · T·D·b     (TP: ``a`` = 6 per
                                                      layer in train, 2
                                                      serving; ``m`` the
                                                      "model" split of
                                                      the weights, ``T``
                                                      the rank's tokens)

  Activation traffic is left out of the memory term, so it is a floor.

Time terms use the NVIDIA H100 SXM5 constants of ``launch/mesh.py``:

    compute    = FLOPs_per_device / 989e12
    memory     = bytes_per_device / 3.35e12
    collective = collective_bytes_per_device / 450e9

**Linearization.**  As in the reference, a cell is costed from its
1-group and 2-group cuts (``launch/dryrun._reduced_cfg``):

    cost(L groups) = cost(1) + (L − 1) · (cost(2) − cost(1))

which is exact for homogeneous stacks and keeps the FLOP count of a deep
model to two small ones.
"""

from __future__ import annotations

import dataclasses
import math

from torch.utils.flop_counter import FlopCounterMode

from ..launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def count_flops(fn) -> float:
    """FLOPs of ``fn()`` as ``FlopCounterMode`` counts them (matmuls,
    convolutions and attention products; elementwise work is free)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@dataclasses.dataclass
class CellCost:
    """Per-device costs for one step."""

    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_counts: dict

    def linearize(self, other: "CellCost", groups: int) -> "CellCost":
        """self = 1-group cost, other = 2-group cost → full-stack cost."""
        d = max(groups - 1, 0)
        return CellCost(
            flops=self.flops + d * (other.flops - self.flops),
            bytes_accessed=self.bytes_accessed + d * (other.bytes_accessed -
                                                      self.bytes_accessed),
            coll_bytes=self.coll_bytes + d * (other.coll_bytes -
                                              self.coll_bytes),
            coll_counts={k: self.coll_counts.get(k, 0) + d * (
                other.coll_counts.get(k, 0) - self.coll_counts.get(k, 0))
                for k in _COLLECTIVES},
        )


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float          # 6·N_active·D analytic
    hlo_flops_global: float     # counted FLOPs, all ranks (the reference's
    useful_ratio: float         # name: its count came from XLA's HLO)

    @classmethod
    def from_cost(cls, cost: CellCost, n_chips: int,
                  model_flops: float) -> "Roofline":
        compute = cost.flops / PEAK_FLOPS_BF16
        memory = cost.bytes_accessed / HBM_BW
        coll = cost.coll_bytes / NVLINK_BW
        terms = {"compute": compute, "memory": memory, "collective": coll}
        dominant = max(terms, key=terms.get)
        hlo_global = cost.flops * n_chips
        return cls(compute_s=compute, memory_s=memory, collective_s=coll,
                   dominant=dominant, model_flops=model_flops,
                   hlo_flops_global=hlo_global,
                   useful_ratio=(model_flops / hlo_global
                                 if hlo_global > 0 else 0.0))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def active_params(cfg) -> float:
    """Parameter count that each token touches (MoE: top-k + shared only)."""
    d = cfg.d_model
    n = 0.0
    # embeddings (tied or not, the matmul cost counts once at the head)
    n += cfg.vocab_size * d
    kinds = cfg.pattern_layers
    for kind in kinds:
        if kind in ("global", "local"):
            if cfg.attention == "mla":
                n += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * (
                    cfg.qk_nope_dim + cfg.qk_rope_dim)
                n += d * cfg.kv_lora_rank + d * cfg.qk_rope_dim
                n += cfg.kv_lora_rank * cfg.num_heads * (
                    cfg.qk_nope_dim + cfg.v_head_dim)
                n += cfg.num_heads * cfg.v_head_dim * d
            else:
                n += d * cfg.num_heads * cfg.head_dim * 2  # wq, wo
                n += d * cfg.num_kv_heads * cfg.head_dim * 2
        elif kind == "rglru":
            w = cfg.lru_width or d
            n += d * w * 2 + w * w * 2 + w * d
        elif kind == "ssm":
            d_inner = cfg.ssm_expand * d
            nh = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
            proj = 2 * d_inner + 2 * cfg.ssm_state + nh
            n += d * proj + d_inner * d
    # FFN: dense layers full; MoE layers top-k routed + shared
    moe_layers = (len(kinds) - cfg.first_k_dense) if cfg.num_experts else 0
    dense_layers = len(kinds) - moe_layers
    if cfg.attention != "none":  # ssm blocks have no separate FFN
        n += dense_layers * 3 * d * cfg.d_ff if cfg.d_ff else 0
    if cfg.num_experts:
        per_expert = 3 * d * cfg.moe_d_ff
        n += moe_layers * (cfg.top_k + cfg.num_shared_experts) * per_expert
    if cfg.is_encoder_decoder:
        # decoder cross-attn on top of the enc+dec self stacks
        n += cfg.dec_layers * d * cfg.num_heads * cfg.head_dim * 4
    return float(n)


def model_flops_for(cfg, shape_kind: str, seq_len: int,
                    global_batch: int) -> float:
    """6·N_active·D(tokens); decode processes 1 token per sequence;
    train pays 3× the forward (fwd+bwd)."""
    n_active = active_params(cfg)
    if shape_kind == "train":
        tokens = global_batch * seq_len
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        tokens = global_batch * seq_len
        return 2.0 * n_active * tokens
    tokens = global_batch * 1
    return 2.0 * n_active * tokens


# ---------------------------------------------------------------------------
# Reckoning from placements (the formulas of the module docstring)
# ---------------------------------------------------------------------------


def _dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _sums(cell) -> dict:
    """Per-role byte sums of a cell's leaves on one rank: ``S`` shards,
    ``P`` compute-size (after FSDP's gather: ÷ the "model" split only)."""
    out = {"S": 0.0, "P": 0.0, "G": 0.0, "O": 0.0, "C": 0.0, "X": 0.0,
           "out": 0.0, "gathered": 0, "coll_out": 0.0}
    for leaf in cell.leaves:
        local = leaf.nbytes / leaf.ways(cell.mesh)
        if leaf.role == "param":
            out["S"] += local
            out["P"] += leaf.nbytes / leaf.ways(cell.mesh, ("model",))
            out["gathered"] += leaf.ways(cell.mesh) > leaf.ways(
                cell.mesh, ("model",))
        elif leaf.role == "grad":
            out["G"] += local
            out["RS"] = out.get("RS", 0.0) + (
                leaf.nbytes / leaf.ways(cell.mesh, ("model",)) - local)
        elif leaf.role == "opt":
            out["O"] += local
        elif leaf.role == "cache":
            out["C"] += local
        elif leaf.role == "batch":
            out["X"] += local
        else:
            out["out"] += local
            if leaf.ways(cell.mesh) == 1:
                out["coll_out"] += leaf.nbytes
    return out


def _tp_ways(cell) -> int:
    """The "model" split of the weights (1 when no weight uses it)."""
    return max((leaf.ways(cell.mesh, ("model",)) for leaf in cell.leaves
                if leaf.role == "param" and leaf.name != "embedding"),
               default=1)


def reckon_cost(cell, flops: float = 0.0) -> CellCost:
    """The cell's per-device :class:`CellCost`: ``flops`` (counted, all
    ranks) ÷ ranks, and the reckoned bytes and collectives."""
    from ..launch.sharding import mesh_axes
    n_chips = math.prod(mesh_axes(cell.mesh).values())
    s = _sums(cell)
    counts = {k: 0 for k in _COLLECTIVES}
    if cell.kind == "query":
        counts["all-gather"] = int(s["coll_out"] > 0)
        read = sum(leaf.nbytes * leaf.reads / leaf.ways(cell.mesh)
                   for leaf in cell.leaves if leaf.role == "batch")
        return CellCost(flops / n_chips, read + s["out"], s["coll_out"],
                        counts)
    cfg = cell.cfg
    gather = s["P"] - s["S"]
    m = _tp_ways(cell)
    layers = (cfg.enc_layers + cfg.dec_layers if cfg.is_encoder_decoder
              else cfg.num_layers)
    batch_ways = math.prod(mesh_axes(cell.mesh)[ax]
                           for ax in cell.batch_axes)
    act = cell.tokens / batch_ways * cfg.d_model * _dtype_bytes(cfg)
    per_ar = 2 * (m - 1) / m * act if m > 1 else 0.0
    if cell.kind == "train":
        bytes_ = 3 * s["P"] + 2 * (s["S"] + s["G"] + s["O"]) + s["X"]
        ar = 6 * layers
        coll = 2 * gather + s.get("RS", 0.0) + ar * per_ar
        counts["all-gather"] = 2 * s["gathered"]
        counts["reduce-scatter"] = s["gathered"]
    else:
        bytes_ = s["P"] + s["C"] + s["X"]
        ar = 2 * layers
        coll = gather + ar * per_ar
        counts["all-gather"] = s["gathered"]
    counts["all-reduce"] = ar if m > 1 else 0
    return CellCost(flops / n_chips, bytes_, coll, counts)


def reckon_memory(cell) -> dict:
    """The reference's ``memory_analysis`` layout, reckoned per rank.

    arguments: the state and inputs a step reads (train: param, optimizer
    and batch shards; serving: param, cache and batch shards); outputs:
    train's new state, serving's logits and cache; temporaries: train's
    gradients plus remat's saved block inputs (one (T, D) per layer, T the
    rank's tokens of one microbatch) and the f32 logits and log-softmax
    of one microbatch, serving's f32 logits; aliases: the donated state
    (train's params and optimizer, serving's cache)."""
    s = _sums(cell)
    if cell.kind == "query":
        arg, out, temp, alias = s["X"], s["out"], 0.0, 0.0
    else:
        from ..launch.sharding import mesh_axes
        cfg = cell.cfg
        batch_ways = math.prod(mesh_axes(cell.mesh)[ax]
                               for ax in cell.batch_axes)
        vocab = next(x for x in cell.leaves if x.name == "embedding")
        v_local = vocab.shape[0] / vocab.ways(cell.mesh, ("model",))
        tokens = cell.tokens / batch_ways
        if cell.kind == "train":
            mb = cfg.microbatches_train_4k or 1
            layers = (cfg.enc_layers + cfg.dec_layers
                      if cfg.is_encoder_decoder else cfg.num_layers)
            t_mb = tokens / mb
            arg = s["S"] + s["O"] + s["X"]
            out = alias = s["S"] + s["O"]
            temp = (s["G"] + layers * t_mb * cfg.d_model * _dtype_bytes(cfg)
                    + 2 * 4 * t_mb * v_local)
        else:
            arg = s["S"] + s["C"] + s["X"]
            out = s["out"] + s["C"]
            alias = s["C"]
            rows = next(x for x in cell.leaves if x.name == "logits").shape[0]
            temp = 4 * rows / batch_ways * v_local
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_estimate_bytes": arg + temp + out - alias}
