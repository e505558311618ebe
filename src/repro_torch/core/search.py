"""Back-compat shim, as `repro.core.search`: the configuration-space
search lives in the `repro_torch.core.sweep` subsystem (bucketed batch
engine). Import from `repro_torch.core` or `repro_torch.core.sweep` in
new code.
"""
from .sweep.search import (Candidate, Evaluation, explore, grid,  # noqa: F401
                           pareto_front, successive_halving)

__all__ = ["Candidate", "Evaluation", "explore", "grid", "pareto_front",
           "successive_halving"]
