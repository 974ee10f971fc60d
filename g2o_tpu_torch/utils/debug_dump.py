"""Failure-diagnostics dump — port of ``g2o_tpu/utils/debug_dump.py``, the
analogue of the reference's ``writeDebug`` (``g2o/core/solver.h:128-131``;
the csparse failure branch ``g2o/solvers/csparse/linear_solver_csparse.h:
128-132`` writes the Hessian as an Octave-loadable text file when a
Cholesky factorization fails).

The observable failure of a step is a non-finite candidate chi2 or an LM
step that exhausts all its trials.  At that point the offending
*linearized system* — per-type Hessian diagonal blocks, the gradient b,
lambda, iteration and chi2 — is copied to the host and written to a
compressed ``.npz`` with the JAX package's keys, which a user loads with
``numpy.load`` to post-mortem conditioning problems.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def dump_failed_system(problem, lin, lam, iteration, directory,
                       reason="", chi2=None):
    """Write ``<directory>/g2o_tpu_debug_it<N>.npz`` with the linearized
    system at a failed step.  Returns the written path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"g2o_tpu_debug_it{int(iteration)}.npz")
    payload = {
        "iteration": np.asarray(int(iteration)),
        "lambda": np.asarray(float(lam)),
        "reason": np.asarray(reason),
    }
    if chi2 is not None:
        payload["chi2"] = np.asarray(float(chi2))
    if getattr(lin, "b", None) is not None:
        payload["b"] = lin.b.cpu().numpy()
    diag = getattr(lin, "diag", None) or {}
    for t, blocks in diag.items():
        payload[f"H_diag_{t}"] = blocks.cpu().numpy()
    fixed = getattr(getattr(problem, "data", None), "fixed", None) or {}
    for t, f in fixed.items():
        payload[f"fixed_{t}"] = f.cpu().numpy()
    # flat tangent offsets so users can map b back to vertices
    for t, vt in getattr(problem, "vertex_types", {}).items():
        payload[f"tangent_dim_{t}"] = np.asarray(int(vt.tangent_dim))
    np.savez_compressed(path, **payload)
    print(f"g2o_tpu_torch: step failed ({reason}); wrote debug system to "
          f"{path}", file=sys.stderr)
    return path
