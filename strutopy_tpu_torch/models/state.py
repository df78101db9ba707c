"""Model state (twin of ``strutopy_tpu/models/state.py``).

EM has no gradient-trained parameters, so the state is a plain
dataclass of tensors that each EM iteration replaces whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class STMState:
    """Global and per-document variational state of an STM fit.

    Shapes (K topics, V vocabulary, N documents incl. padding, P design
    columns, A aspects):
      beta (K, V), or (A, K, V) for a content model; mu, eta (N, K-1);
      sigma (K-1, K-1); theta (N, K); gamma (K-1, P) (zeros for CTM);
      kappa (P_kappa, V) content-model coefficients (0 rows with the LDA
      beta update); bound () ELBO of the last E-step; opt_iters (N,) int32
      Newton iterations per document in the last E-step (drives
      difficulty-sorted chunking); straggler_overflow () int32.
    """

    beta: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    eta: torch.Tensor
    theta: torch.Tensor
    gamma: torch.Tensor
    kappa: torch.Tensor
    bound: torch.Tensor
    opt_iters: torch.Tensor
    straggler_overflow: torch.Tensor


def init_state(generator: Optional[torch.Generator], K: int, V: int, N: int, P: int,
               A: int = 1, content: bool = False, beta_init: Optional[np.ndarray] = None,
               kappa_p: Optional[int] = None, dtype=torch.float32, *,
               device="cuda") -> STMState:
    """Initial state (JAX's arguments in JAX's order; ``generator`` takes
    the place of JAX's PRNG key): sigma = 20 I, mu = eta = 0, theta
    uniform, kappa zeros of ``kappa_p`` rows (the kappa design's width; 0
    with the LDA beta update).

    beta is ``beta_init`` (K, V) (broadcast to (A, K, V) for a content
    model), or, when it is None, rows of Gamma(0.1, 1) draws from
    ``generator`` normalized to the simplex, as the reference draws them
    (the bits are torch's, not ``jax.random``'s).
    """
    if beta_init is None:
        if generator is None:
            raise ValueError("init_state needs a generator to draw beta, or beta_init")
        alpha = torch.full((K, V), 0.1, dtype=torch.float32, device=generator.device)
        g = torch._standard_gamma(alpha, generator=generator)
        beta = (g / torch.sum(g, dim=1, keepdim=True)).to(device=device, dtype=dtype)
    else:
        beta = torch.as_tensor(np.asarray(beta_init), device=device).to(dtype)
    if beta.ndim == 3 and not content:
        beta = beta[0]
    if content and beta.ndim == 2:
        beta = beta[None].expand(A, K, V).contiguous()
    want = (A, K, V) if content else (K, V)
    if beta.shape != want:
        raise ValueError(f"beta_init has shape {tuple(beta.shape)}, expected {want}")
    if kappa_p is None:
        # the width of build_kappa_design with interactions
        kappa_p = K + A + A * K if content else 0

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return STMState(
        beta=beta,
        mu=zeros(N, K - 1),
        sigma=20.0 * torch.eye(K - 1, dtype=dtype, device=device),
        eta=zeros(N, K - 1),
        theta=torch.full((N, K), 1.0 / K, dtype=dtype, device=device),
        gamma=zeros(K - 1, P),
        kappa=zeros(kappa_p, V),
        bound=torch.tensor(float("-inf"), dtype=dtype, device=device),
        opt_iters=zeros(N, dt=torch.int32),
        straggler_overflow=zeros(dt=torch.int32),
    )


def state_to(state: STMState, device) -> STMState:
    """A copy of ``state`` with every tensor on ``device`` (``"cpu"`` parks a
    state on the host, as the JAX package's ``jax.device_get`` does)."""
    return STMState(**{f.name: getattr(state, f.name).to(device)
                       for f in dataclasses.fields(state)})
