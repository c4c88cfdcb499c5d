"""MaskSearch core on PyTorch — the paper's contribution, ported.

Public surface:
  * :mod:`repro_torch.core.cp`      — the CP primitive (exact paths).
  * :mod:`repro_torch.core.chi`     — Cumulative Histogram Index build +
    bounds.
  * :mod:`repro_torch.core.store`   — tiered MasksDatabaseView storage.
  * :mod:`repro_torch.core.exprs`   — CP expressions with interval semantics.
  * :mod:`repro_torch.core.engine`  — filter–verification execution framework.
  * :mod:`repro_torch.core.backend` — execution backends (host / device /
    mesh) under one physical protocol.
  * :mod:`repro_torch.core.distributed` — the mesh: sharded step functions
    and :class:`~repro_torch.core.distributed.DistributedEngine`.
  * :mod:`repro_torch.core.queries` — SQL-ish front-end (demo "Query Command").
"""

from .backend import (DeviceBackend, ExecBackend, HostBackend,  # noqa: F401
                      MeshBackend, get_backend)
from .chi import (CHIConfig, build_chi, build_chi_delta,  # noqa: F401
                  build_chi_np, chi_bounds)
from .engine import (ExecStats, FilteredTopKRun, FilterRun,  # noqa: F401
                     MinMaxAggRun, PairFilteredTopKRun, PairFilterRun,
                     PairTopKRun, ScalarAggRun, TopKRun,
                     filter_query, filtered_topk_query, scalar_agg,
                     topk_query)
from .cp import cp_exact, cp_exact_np, full_roi  # noqa: F401
from .exprs import (CP, AggCP, And, BinOp, Cmp, Const, Not, Or,  # noqa: F401
                    PairTerm, Pred, RoiArea, TypeIn, pair_iou)
from .plan import LogicalPlan, compile_plan, run_plan  # noqa: F401
from .queries import parse, parse_plan, run  # noqa: F401
from .store import (MASK_META_DTYPE, IOStats, MaskStore,  # noqa: F401
                    StaleRunError, StoreSnapshot)
