"""Model state (twin of ``strutopy_tpu/models/state.py``).

EM has no gradient-trained parameters, so the state is a plain
dataclass of tensors that each EM iteration replaces whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class STMState:
    """Global and per-document variational state of an STM fit.

    Shapes (K topics, V vocabulary, N documents incl. padding, P design
    columns):
      beta (K, V); mu, eta (N, K-1); sigma (K-1, K-1); theta (N, K);
      gamma (K-1, P) (zeros for CTM); kappa (0, V) (content model, not
      ported); bound () ELBO of the last E-step; opt_iters (N,) int32
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


def init_state(K: int, V: int, N: int, P: int, beta_init: np.ndarray,
               device, dtype=torch.float32) -> STMState:
    """Initial state from a (K, V) beta: sigma = 20 I, mu = eta = 0,
    theta uniform (reference STM.__init__)."""
    beta = torch.as_tensor(np.asarray(beta_init), device=device).to(dtype)
    if beta.shape != (K, V):
        raise ValueError(f"beta_init has shape {tuple(beta.shape)}, expected {(K, V)}")

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return STMState(
        beta=beta,
        mu=zeros(N, K - 1),
        sigma=20.0 * torch.eye(K - 1, dtype=dtype, device=device),
        eta=zeros(N, K - 1),
        theta=torch.full((N, K), 1.0 / K, dtype=dtype, device=device),
        gamma=zeros(K - 1, P),
        kappa=zeros(0, V),
        bound=torch.tensor(float("-inf"), dtype=dtype, device=device),
        opt_iters=zeros(N, dt=torch.int32),
        straggler_overflow=zeros(dt=torch.int32),
    )
