"""The numbers that decide ``correct``, and their verdict.

Every number is a distance of the program's output from the plain
float64 reference's (``reference/stm_ref.py``), worked out in float64:

* ``gap_max``, ``gap_mean``, ``gap_p50``, ``gap_p90``: a document's
  objective (the negative of its share of the bound that its eta
  maximizes, under the parameters the E-step started from) at the
  program's eta, less the objective at the reference's own optimum, in
  nats: the widest over the documents compared, their mean, median and
  90th percentile.  The Newton solve's answer judged by what it is for,
  so directions the objective hardly sees count for little.
* ``beta_rel``: the worst topic's relative gap of its beta row, L2.
* ``sigma_rel``, ``gamma_rel``: relative Frobenius gaps of the M-step's
  sigma and prevalence coefficients.
* ``bound_rel``: the relative gap of the E-step's summed bound.
* ``start``: the fit's initial state against stm's start for the same
  initial beta: ``beta_rel`` as above (one float32 rounding of each
  entry reads at most 2**-24) and ``state_max``, the largest absolute
  gap of an entry of eta, mu or sigma.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f64(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def eta_numbers(f_prog, f_ref) -> dict:
    gap = f_prog - f_ref
    q = torch.quantile(gap, torch.tensor([0.5, 0.9], dtype=gap.dtype, device=gap.device))
    return {"gap_max": float(gap.max()), "gap_mean": float(gap.mean()),
            "gap_p50": float(q[0]), "gap_p90": float(q[1])}


def rel(a, b) -> float:
    """||a - b|| / ||b|| (Frobenius)."""
    return float(torch.linalg.norm(a - b) / torch.clamp_min(torch.linalg.norm(b), 1e-300))


def fit_numbers(f_prog, ref_e: dict, ref_m: dict, prog: dict) -> dict:
    """The fit's numbers: ``prog`` holds the program's (or a stand-in's)
    eta is judged through ``f_prog``; beta, sigma, gamma (tensors) and
    bound (a float) are compared here."""
    dev = ref_e["f"].device
    out = eta_numbers(f_prog, ref_e["f"])
    beta_p, beta_r = _f64(prog["beta"], dev), ref_m["beta"]
    rows = (torch.linalg.norm(beta_p - beta_r, dim=-1)
            / torch.clamp_min(torch.linalg.norm(beta_r, dim=-1), 1e-300))
    out["beta_rel"] = float(rows.max())
    out["sigma_rel"] = rel(_f64(prog["sigma"], dev), ref_m["sigma"])
    out["gamma_rel"] = rel(_f64(prog["gamma"], dev), ref_m["gamma"])
    b_ref = float(ref_e["bound"].sum())
    out["bound_rel"] = abs(float(prog["bound"]) - b_ref) / abs(b_ref)
    return out


def start_numbers(ref: dict, prog: dict) -> dict:
    """The start's numbers, in float64 on the host: ``beta_rel`` and
    ``state_max``."""
    rows = (np.linalg.norm(prog["beta"] - ref["beta"], axis=-1)
            / np.maximum(np.linalg.norm(ref["beta"], axis=-1), 1e-300))
    return {"beta_rel": float(rows.max()),
            "state_max": max(float(np.abs(prog[k] - ref[k]).max()) for k in ("eta", "mu", "sigma"))}


def passes(check: dict) -> bool:
    return math.isfinite(check["value"]) and check["value"] <= check["limit"]


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number that has a limit at or below it and
    finite (a limit whose number is missing reads NaN and fails).  The
    other numbers are readings, not compared."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    return all(passes(c) for c in checks.values()), checks


def check_lines(checks: dict) -> list:
    return [f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if passes(c) else 'FAIL'}"
            for k, c in checks.items()]
