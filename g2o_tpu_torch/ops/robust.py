"""Robust kernels on tensors — port of ``g2o_tpu/ops/robust.py``.

Each kernel maps the squared error ``e2 = e^T Omega e`` to
``(rho, rho', rho'')`` stacked on the last axis, with the formulas of the
reference ``g2o/core/robust_kernel_impl.cpp:50-170``.  Kernels are named by
a small integer id; a batch whose edges share one kernel dispatches
statically (:func:`robustify` with an ``int``), a mixed batch evaluates
every kernel and selects per edge (:func:`robustify_batch`).
"""

from __future__ import annotations

import torch

# kernel ids (order fixed — the same ids as the JAX package)
NONE = 0
HUBER = 1
PSEUDO_HUBER = 2
CAUCHY = 3
GEMAN_MCCLURE = 4
WELSCH = 5
FAIR = 6
TUKEY = 7
SATURATED = 8
DCS = 9

KERNEL_IDS = {
    "": NONE,
    "None": NONE,
    "Huber": HUBER,
    "PseudoHuber": PSEUDO_HUBER,
    "Cauchy": CAUCHY,
    "GemanMcClure": GEMAN_MCCLURE,
    "Welsch": WELSCH,
    "Fair": FAIR,
    "Tukey": TUKEY,
    "Saturated": SATURATED,
    "DCS": DCS,
}


def _rho_none(e2, delta):
    return torch.stack([e2, torch.ones_like(e2), torch.zeros_like(e2)], dim=-1)


def _rho_huber(e2, delta):
    dsqr = delta * delta
    sqrte = torch.sqrt(torch.clamp_min(e2, 1e-300))
    r1 = delta / sqrte
    out = torch.stack([2.0 * sqrte * delta - dsqr, r1, -0.5 * r1 / e2], dim=-1)
    return torch.where((e2 <= dsqr)[..., None], _rho_none(e2, delta), out)


def _rho_pseudo_huber(e2, delta):
    dsqr = delta * delta
    dsqr_r = 1.0 / dsqr
    aux1 = dsqr_r * e2 + 1.0
    aux2 = torch.sqrt(aux1)
    r1 = 1.0 / aux2
    return torch.stack(
        [2.0 * dsqr * (aux2 - 1.0), r1, -0.5 * dsqr_r * r1 / aux1], dim=-1)


def _rho_cauchy(e2, delta):
    dsqr = delta * delta
    dsqr_r = 1.0 / dsqr
    aux = dsqr_r * e2 + 1.0
    r1 = 1.0 / aux
    return torch.stack([dsqr * torch.log(aux), r1, -dsqr_r * r1 * r1], dim=-1)


def _rho_geman_mcclure(e2, delta):
    # rho'' is the true derivative d(rho')/d(e2), as in the JAX package
    # (the reference's differs; rho'' is unused by the quadratic form)
    aux = delta / (delta + e2)
    r1 = aux * aux
    return torch.stack([e2 * aux, r1, -2.0 * r1 * aux / delta], dim=-1)


def _rho_welsch(e2, delta):
    dsqr = delta * delta
    aux2 = torch.exp(-e2 / dsqr)
    return torch.stack([dsqr * (1.0 - aux2), aux2, -aux2 / dsqr], dim=-1)


def _rho_fair(e2, delta):
    sqrte = torch.sqrt(torch.clamp_min(e2, 1e-300))
    aux = sqrte / delta
    return torch.stack(
        [
            2.0 * delta * delta * (aux - torch.log1p(aux)),
            1.0 / (1.0 + aux),
            -0.5 / (delta * sqrte * (1.0 + aux) ** 2),
        ],
        dim=-1,
    )


def _rho_tukey(e2, delta):
    e = torch.sqrt(torch.clamp_min(e2, 0.0))
    delta2 = delta * delta
    aux = e2 / delta2
    omaux = 1.0 - aux
    inlier = torch.stack(
        [delta2 * (1.0 - omaux ** 3) / 3.0, omaux * omaux, -2.0 * omaux / delta2],
        dim=-1)
    zero = torch.zeros_like(e2)
    outlier = torch.stack(
        [torch.ones_like(e2) * delta2 / 3.0, zero, zero], dim=-1)
    return torch.where((e <= delta)[..., None], inlier, outlier)


def _rho_saturated(e2, delta):
    dsqr = delta * delta
    zero = torch.zeros_like(e2)
    outlier = torch.stack([torch.ones_like(e2) * dsqr, zero, zero], dim=-1)
    return torch.where((e2 <= dsqr)[..., None], _rho_none(e2, delta), outlier)


def _rho_dcs(e2, delta):
    phi = delta
    scale = torch.clamp_max((2.0 * phi) / (phi + e2), 1.0)
    return torch.stack(
        [scale * e2 * scale, scale * scale, torch.zeros_like(e2)], dim=-1)


_KERNELS = [
    _rho_none,
    _rho_huber,
    _rho_pseudo_huber,
    _rho_cauchy,
    _rho_geman_mcclure,
    _rho_welsch,
    _rho_fair,
    _rho_tukey,
    _rho_saturated,
    _rho_dcs,
]


def robustify(kernel_id, e2, delta):
    """(rho, rho', rho'') on the last axis.  ``kernel_id`` is a static
    ``int`` (one kernel for the whole batch) or a per-edge id tensor."""
    if isinstance(kernel_id, int):
        return _KERNELS[kernel_id](e2, delta)
    return robustify_batch(kernel_id, e2, delta)


def robustify_batch(kernel_ids, e2, deltas):
    """Per-edge kernel ids ``(E,)`` -> ``(E, 3)``: every kernel is
    evaluated and each edge takes its own row (the unselected values may
    be inf/NaN; selection never mixes them in)."""
    every = torch.stack([k(e2, deltas) for k in _KERNELS])      # (K, E, 3)
    rows = torch.arange(e2.shape[0], device=e2.device)
    return every[kernel_ids.long(), rows]
