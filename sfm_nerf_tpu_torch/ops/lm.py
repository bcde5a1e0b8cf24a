"""Levenberg-Marquardt over a batch of small independent problems.

Same algorithm as sfm_nerf_tpu/ops/lm.py: a fixed number of damped
Gauss-Newton steps with the classic accept/reject schedule (accept: lambda
times ``lambda_down``; reject: times ``lambda_up``).  The JAX package vmaps
one solve over its callers' batch; here the batch is explicit and every
step is one batched launch sequence:

- the residual and its Jacobian come from ``torch.func.vmap`` of
  ``residual_fn`` and of ``torch.func.jacfwd(residual_fn)``;
- the damped normal system is solved by ``torch.linalg.solve_ex``, which
  gives non-finite steps on a singular matrix (rejected like JAX's) and
  reads nothing back to the host;
- the loop has a fixed trip count and no data-dependent exit.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jacfwd, vmap


def levenberg_marquardt(
    residual_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    *args: torch.Tensor,
    n_iters: int = 20,
    lambda0: float = 1e-3,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize ||r(x_b)||² for each b.  ``x0`` (B, P); ``args`` batched on
    dim 0; ``residual_fn(x (P,), *one_item_of_each_arg) -> (M,)`` may close
    over tensors shared by the batch.  Returns (x_opt (B, P), initial
    cost (B,), final cost (B,))."""
    res = vmap(residual_fn)
    jac = vmap(jacfwd(residual_fn))

    def cost(x):
        r = res(x, *args)
        return torch.sum(r * r, dim=-1)

    P = x0.shape[-1]
    eye = torch.eye(P, dtype=x0.dtype, device=x0.device)
    x = x0
    c0 = cost(x0)
    c = c0
    lam = torch.full_like(c0, lambda0)
    for _ in range(n_iters):
        r = res(x, *args)                            # (B, M)
        J = jac(x, *args)                            # (B, M, P)
        JtJ = J.transpose(-1, -2) @ J
        Jtr = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        A = JtJ + lam[:, None, None] * eye
        dx = -torch.linalg.solve_ex(A, Jtr)[0]
        x_new = x + dx
        c_new = cost(x_new)
        improved = torch.isfinite(c_new) & (c_new < c)
        x = torch.where(improved[:, None], x_new, x)
        c = torch.where(improved, c_new, c)
        lam = torch.where(improved, lam * lambda_down, lam * lambda_up)
        lam = torch.clamp(lam, 1e-12, 1e12)
    return x, c0, c
