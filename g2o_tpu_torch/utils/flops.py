"""Analytic FLOP model for MFU reporting — port of
``g2o_tpu/utils/flops.py``.

Counts the ALGORITHMIC floating-point work of an LM optimization — the
multiply-adds mathematically required by the formulas (residual/Jacobian
production, H/b assembly, CG matvecs, preconditioner builds/applies) — not
the operations the card happens to execute (padding, masking, index and
layout work are deliberately excluded; they are overhead, not useful
work).  MFU numbers derived from this model are therefore conservative
lower bounds on hardware utilization.

The model mirrors the reference's own cost accounting axes
(``g2o/core/batch_stats.h:47-71``: residuals / quadratic form / linear
solve), using the measured per-iteration CG and λ-trial counts that
``optimize_fused`` returns (``cg_per_iteration``, ``trials_per_iteration``).

Peaks: NVIDIA's published H100 figures for the dtype the problem computes
in.  The package turns TF32 off, so float32 work runs on the CUDA cores
(FP32); float64 is held to the FP64 tensor-core peak, the larger of the
two FP64 figures.  A card missing from the table, and the CPU, have no
peak: :func:`device_peak_flops` and :func:`mfu_report` then return
``None``.
"""

from __future__ import annotations

import torch

# torch.cuda.get_device_name() substring -> {dtype: peak FLOP/s}, from
# NVIDIA's H100 datasheet (dense, no sparsity)
_PEAKS = {
    # H100 SXM5 ("NVIDIA H100 80GB HBM3"): FP32 67, FP64 tensor core 67
    "H100 80GB HBM3": {torch.float32: 67e12, torch.float64: 67e12},
    "H100 SXM": {torch.float32: 67e12, torch.float64: 67e12},
    # H100 PCIe: FP32 51, FP64 tensor core 51
    "H100 PCIe": {torch.float32: 51e12, torch.float64: 51e12},
}


def device_peak_flops(device=None, dtype=torch.float32) -> float | None:
    """The published peak FLOP/s of ``device`` (a torch device, an index
    or a device name; the current CUDA device when None) for ``dtype``, or
    ``None`` for the CPU, a card missing from the table, or a dtype it
    has no figure for."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(dev)
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks.get(dtype)
    return None


def _edge_shapes(problem):
    """Per edge type: (E, r, [slot tangent dims])."""
    out = {}
    for name, et in problem.edge_types.items():
        E = int(problem.data.edges[name].vidx.shape[0])
        r = int(et.residual_dim)
        dims = [vt.tangent_dim for vt in et.vertex_types]
        out[name] = (E, r, dims)
    return out


def linearize_flops(problem) -> float:
    """One linearization: residual + Jacobian production, robust weights,
    H-block/diagonal assembly, gradient, chi2.

    Per edge: J_s is (r, d_s) per slot (forward mode ≈ one residual-sized matmul
    per tangent column → 2·r·Σd), W·J_s costs 2·r²·d_s, each H_ab block
    2·r·d_a·d_b (diagonal slots + upper off-diagonal pairs), b = JᵀWe
    2·r·Σd, chi2 2·r²."""
    total = 0.0
    for E, r, dims in _edge_shapes(problem).values():
        sd = sum(dims)
        j_prod = 2.0 * r * sd
        wj = sum(2.0 * r * r * d for d in dims)
        h_blocks = sum(2.0 * r * dims[a] * dims[b]
                       for a in range(len(dims))
                       for b in range(a, len(dims)))
        b_grad = 2.0 * r * sd
        chi2 = 2.0 * r * r
        total += E * (j_prod + wj + h_blocks + b_grad + chi2)
    return total


def chi2_flops(problem) -> float:
    """One chi2 evaluation (residual + eᵀΩe per edge)."""
    return sum(E * (2.0 * r * r + 4.0 * r)
               for E, r, _ in _edge_shapes(problem).values())


def matvec_flops(problem) -> float:
    """One damped full-system H·v: J·v and Jᵀ·u per slot + W·u."""
    total = 0.0
    for E, r, dims in _edge_shapes(problem).values():
        total += E * (sum(4.0 * r * d for d in dims) + 2.0 * r * r)
    for t, vt in problem.vertex_types.items():
        total += 2.0 * problem.counts[t] * vt.tangent_dim   # + λv
    return total


def _pcg_flops(problem, solver, cg_iters: float, trials: float) -> float:
    """PCGSolver: per-trial preconditioner build + cg_iters × (matvec +
    preconditioner apply + recurrence axpys)."""
    tangent = sum(problem.counts[t] * vt.tangent_dim
                  for t, vt in problem.vertex_types.items())
    axpy = 10.0 * tangent                       # x,r,p updates + dots
    precond = getattr(solver, "precond", "jacobi")
    if precond in ("chunk", "chunk2"):
        (tname,) = problem.vertex_types
        d = problem.vertex_types[tname].tangent_dim
        n = problem.counts[tname]
        c = solver.chunk_size
        nc = -(-n // c)
        cd = c * d
        build = nc * (cd ** 3 / 3.0 + 2.0 * cd ** 3)   # chol + inverse
        apply_ = 2.0 * nc * cd * cd
        if precond == "chunk2":
            ncd = nc * d
            ncd_pad = -(-ncd // 96) * 96
            build += ncd_pad ** 3 / 3.0 + 2.0 * ncd_pad ** 3
            build += sum(E * 2.0 * r * d * d
                         for E, r, _ in _edge_shapes(problem).values())
            apply_ += 2.0 * ncd_pad * ncd_pad
    else:
        build = sum(problem.counts[t] * vt.tangent_dim ** 3
                    for t, vt in problem.vertex_types.items())
        apply_ = sum(2.0 * problem.counts[t] * vt.tangent_dim ** 2
                     for t, vt in problem.vertex_types.items())
    return (trials * build
            + cg_iters * (matvec_flops(problem) + apply_ + axpy))


def _implicit_schur_flops(problem, solver, cg_iters: float,
                          trials: float) -> float:
    """ImplicitSchurSolver: per-trial setup (B blocks, Hll, Dinv,
    schur-jacobi diagonal, bschur) + cg_iters × reduced matvec."""
    marg = {t: bool(m.all()) for t, m in problem.marginalized.items()}
    pose_n = sum(problem.counts[t] for t, v in marg.items() if not v)
    dp = max((problem.vertex_types[t].tangent_dim
              for t, v in marg.items() if not v), default=0)
    dl = max((problem.vertex_types[t].tangent_dim
              for t, v in marg.items() if v), default=0)
    lm_n = sum(problem.counts[t] for t, v in marg.items() if v)

    # classify edge slots by their vertex type's marginalized flag (NOT by
    # tangent-dim equality: pose/landmark dims can coincide, and then the
    # dim-membership test misattributes FLOPs)
    def _slot_marg(et):
        return [marg.get(vt.name, False) for vt in et.vertex_types]

    obs = 0.0
    setup = 0.0
    for name, (E, r, dims) in _edge_shapes(problem).items():
        sm = _slot_marg(problem.edge_types[name])
        if len(dims) == 2 and sm.count(True) == 1:
            obs += E
            # B = Jpᵀ W Jl, Hll contribution, Hpp contribution
            setup += E * (2.0 * r * r * dl + 2.0 * r * dp * dl
                          + 2.0 * r * dl * dl + 2.0 * r * dp * dp)
    setup += lm_n * dl ** 3                       # Dinv (3x3 closed form)
    setup += obs * 2.0 * dp * dl * (dp + dl)      # schur-jacobi diagonal
    setup += obs * 4.0 * dp * dl                  # bschur reduction
    setup += pose_n * dp ** 3                     # precond inverse

    # reduced S·v: Bᵀu, Dinv·t, B·s + Hpp·v (diag + pose-pose edges)
    mv = obs * 4.0 * dp * dl + lm_n * 2.0 * dl * dl + pose_n * 2.0 * dp * dp
    for name, (E, r, dims) in _edge_shapes(problem).items():
        if len(dims) == 2 and not any(_slot_marg(problem.edge_types[name])):
            mv += E * 4.0 * r * dp
    apply_ = pose_n * 2.0 * dp * dp
    axpy = 10.0 * pose_n * dp
    backsub = obs * 2.0 * dp * dl + lm_n * 2.0 * dl * dl
    return (trials * (setup + backsub)
            + cg_iters * (mv + apply_ + axpy))


def run_flops(problem, solver, res: dict) -> float | None:
    """Total algorithmic FLOPs of an ``optimize_fused`` result dict.
    Returns None when no model exists for the solver type."""
    iters = res.get("iterations", 0)
    cg = float(sum(res.get("cg_per_iteration", [])))
    trials = float(sum(res.get("trials_per_iteration", [iters]))) or iters
    name = getattr(solver, "name", "")
    if name == "pcg":
        per_solver = _pcg_flops(problem, solver, cg, trials)
    elif name == "schur_implicit":
        per_solver = _implicit_schur_flops(problem, solver, cg, trials)
    else:
        return None
    # each iteration: 1 linearize (includes chi2); each trial: apply + chi2
    return (iters * linearize_flops(problem)
            + trials * chi2_flops(problem)
            + per_solver)


def mfu_report(problem, solver, res: dict, device=None) -> dict | None:
    """FLOPs, achieved FLOP/s and the share of the card's peak for the
    problem's dtype of one ``optimize_fused`` result; ``None`` when the
    solver has no model, the result no wall time, or the device no peak
    (the problem's device when ``device`` is None)."""
    flops = run_flops(problem, solver, res)
    if flops is None or not res.get("wall_s"):
        return None
    dev = problem.device if device is None else device
    peak = device_peak_flops(dev, problem.dtype)
    if peak is None:
        return None
    achieved = flops / res["wall_s"]
    return {
        "algorithmic_flops": float(flops),
        "achieved_flops_per_s": float(achieved),
        "peak_flops_per_s": float(peak),
        "peak_dtype": str(problem.dtype).replace("torch.", ""),
        "mfu_vs_peak": float(achieved / peak),
    }
