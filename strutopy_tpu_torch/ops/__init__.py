from strutopy_tpu_torch.ops.linalg import make_pd, chol_pd, cho_inverse, precompute_sigma
from strutopy_tpu_torch.ops.estep import EStepResult, run_estep

__all__ = [
    "make_pd",
    "chol_pd",
    "cho_inverse",
    "precompute_sigma",
    "EStepResult",
    "run_estep",
]
