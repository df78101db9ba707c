"""Typed configuration for STM fits.

Same field names, defaults and validation as
``strutopy_tpu/models/config.py``, so a configuration written by either
package (``STMConfig.to_json``) loads in the other with ``from_json``.

Differences, all explicit:

  * the Newton path: by default each iteration runs the three CUDA stage
    kernels (f/g/H, CG, the Armijo sweep); ``pallas_iter`` runs each
    iteration as one fused kernel, ``use_pallas`` the whole loop of a
    chunk as one kernel (single pass: it excludes ``newton_pass1_iters``,
    as in JAX).  The names are the JAX package's.  ``two_pass_fused`` and
    ``newton_bf16_beta`` are E-step options that run here as in JAX (the
    bf16 beta_doc on the kernels' bf16-input modes);
  * ``pallas_fgh``/``pallas_cg``/``pallas_ls`` have no fields: the stage
    kernels are the default path here (``from_json`` drops the keys,
    ``to_json`` writes them False, the JAX defaults);
  * knobs that steer the TPU compiler or its kernels' blocking
    (:data:`TPU_ONLY`) are fields with their JAX defaults and raise when
    set to anything else — a configuration tuned for the TPU must not be
    silently reinterpreted.
"""

from __future__ import annotations

import dataclasses
import json

# field -> the only accepted value (the JAX default)
TPU_ONLY = {
    "pallas_block": 8,
    "cg_chunk_docs": 0,
    "scan_unroll": 1,
    "chol_block": 0,
}


def refuse_tpu_only(name: str, value) -> None:
    """Raise unless the TPU-only setting ``name`` has its JAX default
    (``TPU_ONLY[name]``; None for an argument not in it)."""
    default = TPU_ONLY.get(name)
    if value != default:
        raise ValueError(
            f"{name}={value!r} is a TPU-only setting; "
            f"the PyTorch port accepts only {default!r}"
        )


# JAX fields the port accepts in from_json and drops: the stage kernels
# are the default path here
STAGE_FLAGS = ("pallas_fgh", "pallas_cg", "pallas_ls")


@dataclasses.dataclass(frozen=True)
class STMConfig:
    """Configuration of an STM/CTM fit (see the JAX twin for each field)."""

    K: int
    # topical content
    content: bool = False
    A: int = 1
    kappa_interactions: bool = False
    lda_beta: bool = True
    # additive pseudocount on beta_ss before the row normalization
    beta_smoothing: float = 0.0
    # prevalence regression
    model_type: str = "STM"  # "STM" | "CTM"
    mode: str = "ols"  # "ols" | "ridge" | "lasso"
    fit_intercept: bool = True
    ridge_alpha: float = 0.1
    lasso_alpha: float = 1.0
    # EM loop
    max_em_iter: int = 100
    convergence_threshold: float = 1e-5
    sigma_prior: float = 0.0
    # initialization
    init_type: str = "spectral"  # "spectral" | "random"
    seed: int = 123456
    spectral_max_v: int = 5000
    # content-model (kappa) Poisson regression
    kappa_l2: float = 250.0
    kappa_newton_iters: int = 40
    kappa_grad_tol: float = 1e-6
    kappa_ftol_rel: float = 0.0
    # E-step solver
    newton_max_iters: int = 24
    newton_grad_tol: float = 1e-5
    newton_max_backtracks: int = 12
    newton_cg_iters: int = 6
    newton_bf16_hessian: bool = True  # bf16 B·Bᵀ operand for the in-loop Hessian
    newton_fixed_iters: bool = False
    # two-pass straggler schedule (ops/estep.py::_two_pass_estep); 0 = off
    newton_pass1_iters: int = 0
    newton_straggler_frac: float = 0.3
    # finalize inside passes 1 and 2 (ops/estep.py::_two_pass_fused_estep)
    two_pass_fused: bool = False
    newton_warmup_iters: int = 2
    # execution
    batch_size: int = 256
    use_pallas: bool = False  # the whole Newton loop as one kernel (single pass)
    pallas_iter: bool = False  # each Newton iteration as one fused kernel
    pallas_block: int = 8  # TPU only
    cg_chunk_docs: int = 0  # TPU only
    newton_bf16_beta: bool = False  # bf16 beta_doc in the Newton search, float32 finalize
    # "blocked" and "chol" are the same factorization here (the blocked
    # form only worked around the TPU compiler); "ns" is not ported
    nu_method: str = "blocked"
    chol_block: int = 0  # TPU only (block size of the blocked Cholesky)
    likelihood_temper: float = 1.0
    debug_checks: bool = False
    auto_bucket: bool = True
    max_buckets: int = 4
    sort_by_difficulty: bool = True
    scan_unroll: int = 1  # TPU only

    def __post_init__(self):
        if self.K < 2:
            raise ValueError("Number of topics K must be >= 2")
        if self.model_type not in ("STM", "CTM"):
            raise ValueError(f"model_type must be STM or CTM, got {self.model_type}")
        if self.mode not in ("ols", "ridge", "lasso"):
            raise ValueError(f"mode must be ols/ridge/lasso, got {self.mode}")
        if self.init_type not in ("spectral", "random"):
            raise ValueError(f"init_type must be spectral or random, got {self.init_type}")
        if not 0.0 <= self.sigma_prior <= 1.0:
            raise ValueError("sigma_prior must be in [0, 1]")
        if self.content and self.A < 2:
            raise ValueError("content=True requires A >= 2 aspects")
        if self.beta_smoothing < 0.0:
            raise ValueError("beta_smoothing must be >= 0")
        if self.nu_method not in ("chol", "ns", "blocked"):
            raise ValueError(
                f"nu_method must be chol, ns or blocked, got {self.nu_method}")
        if self.newton_pass1_iters < 0 or self.newton_pass1_iters >= self.newton_max_iters and self.newton_pass1_iters != 0:
            raise ValueError(
                "newton_pass1_iters must be 0 (off) or in [1, newton_max_iters)"
            )
        if not 0.0 < self.newton_straggler_frac <= 1.0:
            raise ValueError("newton_straggler_frac must be in (0, 1]")
        if self.newton_warmup_iters < 0:
            raise ValueError("newton_warmup_iters must be >= 0")
        if not 0.0 < self.likelihood_temper <= 1.0:
            raise ValueError("likelihood_temper must be in (0, 1]")
        if self.newton_pass1_iters and self.use_pallas:
            raise ValueError(
                "the two-pass schedule is incompatible with the whole-loop "
                "kernel (use_pallas); the stage kernels are fine"
            )
        for name in TPU_ONLY:
            refuse_tpu_only(name, getattr(self, name))
        if self.nu_method == "ns":
            raise ValueError(
                "nu_method='ns' (Newton-Schulz inverse) is a TPU-only setting; "
                "the PyTorch port computes nu from the Cholesky factor "
                "(use 'chol' or 'blocked')"
            )

    def to_json(self) -> str:
        """The JAX package's JSON: its keys in its order, the stage flags
        (which have no fields here) written False."""
        d = {}
        for k, v in dataclasses.asdict(self).items():
            d[k] = v
            if k == "use_pallas":
                d.update(dict.fromkeys(STAGE_FLAGS, False))
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "STMConfig":
        d = json.loads(s)
        for k in STAGE_FLAGS:
            d.pop(k, None)
        return cls(**d)

    def replace(self, **kw) -> "STMConfig":
        return dataclasses.replace(self, **kw)
