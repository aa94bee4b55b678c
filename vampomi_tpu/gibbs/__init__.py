"""Spike-and-slab Gibbs sampler (GMRMomi-analog warm-start stage).

See sampler.py for the block residual-update design and runner.py for the
GMRM-compatible output formats consumed by scripts/conf_gibbs_init.py and
scripts/pip.py (reference README.md:170-213).
"""

from .runner import GibbsResult, run_gibbs
from .sampler import (
    GibbsState,
    block_update,
    build_block_grams,
    decade_cvars,
    gibbs_sweep,
    init_state,
)

__all__ = [
    "GibbsResult",
    "GibbsState",
    "block_update",
    "build_block_grams",
    "decade_cvars",
    "gibbs_sweep",
    "init_state",
    "run_gibbs",
]
