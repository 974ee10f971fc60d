"""Incremental / online optimization — port of ``g2o_tpu/core/incremental.py``,
the analogue of the reference's ``SparseOptimizer::updateInitialization``
online mode (``g2o/core/sparse_optimizer.cpp:465-502``) and the
``g2o -inc`` / ``g2o_incremental`` flow (``apps/g2o_cli/g2o.cpp:373-460``).

"Grow the active structures without re-initialising": the compiled problem
is *capacity-padded* — ``vertex_chunk`` vertex slots per type beyond the
live count are pinned (fixed) placeholders, and edge slots beyond the live
count are inactive padding rows (``edge_chunk`` at a time).  Adding a
vertex or an edge writes its rows in place into the problem's tensors
(estimates row, edge batch rows, fixed flags and masks): a few small
host→device copies, with no new ``Problem`` and no solver set-up.  Only
when a capacity overflows is the problem compiled anew, with fresh slack
(``recompiles`` counts those) — the analogue of the reference's
"buildStructure once, reuse the pattern" contract
(``g2o/core/block_solver.hpp:103``).  The layout, and so the chunk
assignment of the chunked preconditioners, is the JAX package's.

Edges written since the last solve change the structure a solver may have
read at set-up: the chunked PCG preconditioners get their index maps
recomputed (:meth:`PCGSolver.refresh_chunk_maps`), and every other solver
is set up again on the same problem: the Cholesky, Schur and CGLS solvers
read the edge→vertex indices at set-up.  (The JAX package refreshes
only PCG's maps, so its direct solvers keep factoring the pattern of their
last compile: ROADMAP C.5.)
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.optimizer import SparseOptimizer
from g2o_tpu_torch.core.solvers.pcg import PCGSolver


class IncrementalOptimizer:
    """Online wrapper: add vertices/edges, call :meth:`optimize` anytime.
    The problem is built in ``dtype`` (float64 when None) on ``device``."""

    def __init__(self, *, algorithm_factory=None, solver_factory=None,
                 edge_chunk: int = 256, vertex_chunk: int = 128,
                 verbose: bool = False, init_from_edges: bool = True,
                 dtype=None, device="cuda"):
        from g2o_tpu_torch.core.optimizer import LevenbergMarquardt

        self.graph = Graph()
        self.edge_chunk = int(edge_chunk)
        self.vertex_chunk = int(vertex_chunk)
        self.verbose = verbose
        self.dtype = dtype
        self.device = device
        # reference `g2o -inc` behaviour (``apps/g2o_cli/g2o.cpp:440-492``):
        # a vertex first seen through a new edge is initialised by the
        # edge's initialEstimate rule from the already-placed endpoint
        self.init_from_edges = bool(init_from_edges)
        self._fresh: set[int] = set()
        self._algorithm_factory = algorithm_factory or LevenbergMarquardt
        self._solver_factory = solver_factory or (
            lambda: PCGSolver(max_iter=100, tol=1e-8))
        self._problem = None
        self._opt = None
        self._live_edges: dict[str, int] = {}
        self._recompiles = 0
        self._edges_dirty = False
        self._est_host = None       # host copy of the problem's estimates
        self._fixed_host = {}       # host copy of its fixed flags

    # ------------------------------------------------------------------ #

    def _row(self, x):
        """A host row as a tensor of the problem's dtype (copied into the
        device tensor by the indexed assignment)."""
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=self._problem.dtype)

    def add_vertex(self, vid, vtype, estimate, *, fixed=False):
        self.graph.add_vertex(vid, vtype, estimate, fixed=fixed)
        if self.init_from_edges and not fixed:
            self._fresh.add(vid)
        if self._problem is not None:
            t = (vtype if isinstance(vtype, str) else vtype.name)
            slot = self._next_vertex_slot(t)
            if slot is None:
                self._invalidate()
            else:
                p = self._problem
                self._write_estimate(t, slot, estimate)
                p.data.fixed[t][slot] = bool(fixed)
                self._fixed_host[t][slot] = bool(fixed)
                d = p.vertex_types[t].tangent_dim
                off = p.type_bases[t] + slot * d
                p.data.fixed_flat[off:off + d] = 1.0 if fixed else 0.0
                p.vid_index[vid] = (t, slot)
                self._live_counts[t] += 1
        return vid

    def add_edge(self, etype, vids, measurement, information, **kw):
        self.graph.add_edge(etype, vids, measurement, information, **kw)
        if self.init_from_edges:
            self._init_fresh_through_edge(self.graph.edges()[-1])
        if self._problem is None:
            return
        rec = self.graph.edges()[-1]
        name = rec.etype.name
        p = self._problem
        if rec.level != 0:
            # compile() excludes level != 0 edges; writing one into the
            # level-0 batch would make chi2 jump across the next recompile.
            # The graph keeps it; the compiled problem ignores it —
            # consistent with a recompile.
            return
        if name not in p.data.edges or \
                self._live_edges[name] >= p.data.edges[name].vidx.shape[0]:
            self._invalidate()
            return
        i = self._live_edges[name]
        b = p.data.edges[name]
        slots = [p.vid_index[v] for v in rec.vids]
        b.vidx[i] = torch.as_tensor([s for _, s in slots], dtype=torch.int64)
        b.meas[i] = self._row(rec.measurement)
        b.info[i] = self._row(rec.information)
        b.kernel[i] = int(rec.kernel)
        b.delta[i] = float(rec.delta)
        b.active[i] = bool(rec.active)
        if rec.etype.param_dim:
            b.param[i] = self._row(np.concatenate(
                [self.graph.parameter(pid) for pid in rec.param_id]))
        # the fixed-vertex Jacobian multiplier of this row (placeholder
        # rows were built against other vertices)
        p.data.free_mask[name][i] = self._row(
            [0.0 if self._fixed_host[t][s] else 1.0 for t, s in slots])
        self._live_edges[name] = i + 1
        if p.n_active_edges is not None and rec.active:
            p.n_active_edges += 1     # keep the host-side count current
        self._edges_dirty = True

    def _init_fresh_through_edge(self, rec):
        """Initialise endpoints first seen through this edge from the other
        (already-placed) endpoint via the edge type's initialEstimate rule —
        the reference's online-vertex initialisation
        (``apps/g2o_cli/g2o.cpp:457-492``)."""
        from g2o_tpu_torch.core.initial_guess import _propagate_rule

        fresh_slots = [s for s, v in enumerate(rec.vids) if v in self._fresh]
        if not fresh_slots:
            return
        if len(fresh_slots) == len(rec.vids) and len(rec.vids) > 1:
            return  # no initialised endpoint to propagate from
        rule = _propagate_rule(rec.etype.name)
        if rule is None:
            return
        verts = self.graph.vertices()
        states = [self._current_estimate(v) for v in rec.vids]
        param = (np.concatenate([self.graph.parameter(pid)
                                 for pid in rec.param_id])
                 if rec.param_id is not None else None)
        for s in fresh_slots:
            new = rule(states, rec.measurement, param, s)
            if new is None:
                continue
            vid = rec.vids[s]
            new = np.asarray(new, dtype=np.float64)
            verts[vid].estimate = new
            self._fresh.discard(vid)
            if self._problem is not None and vid in self._problem.vid_index:
                self._write_estimate(*self._problem.vid_index[vid], new)

    def _current_estimate(self, vid):
        p = self._problem
        if p is not None and vid in p.vid_index:
            if self._est_host is None:
                # one copy of every estimate per optimize, not one read of
                # the device per edge
                self._est_host = {t: e.cpu().numpy()
                                  for t, e in p.estimates.items()}
            t, i = p.vid_index[vid]
            return self._est_host[t][i].copy()
        return np.asarray(self.graph.vertices()[vid].estimate)

    def _write_estimate(self, t, slot, value):
        """Write one estimate row on the device, and into the host copy
        (rounded to the problem's dtype as the device row is)."""
        self._problem.estimates[t][slot] = self._row(value)
        if self._est_host is not None:
            self._est_host[t][slot] = np.asarray(value, dtype=np.float64)

    # ------------------------------------------------------------------ #

    def _next_vertex_slot(self, t):
        p = self._problem
        if t not in p.counts:
            return None
        n = self._live_counts[t]
        return n if n < p.counts[t] else None

    def _invalidate(self):
        self._problem = None
        self._opt = None

    def _compile(self):
        # build a capacity-padded copy: reserve extra pinned vertices and
        # inactive edge rows so future adds are in-place writes
        g = Graph(self.graph.registry)
        by_type_counts: dict[str, int] = {}
        for vid in sorted(self.graph.vertices()):
            rec = self.graph.vertices()[vid]
            g.add_vertex(vid, rec.vtype, rec.estimate, fixed=rec.fixed,
                         marginalized=rec.marginalized)
            by_type_counts[rec.vtype.name] = \
                by_type_counts.get(rec.vtype.name, 0) + 1
        for pid, val in self.graph.parameters().items():
            g.add_parameter(pid, val)
        # reserve pinned placeholder vertices with ids ABOVE any real id so
        # they occupy the trailing slots of each per-type array
        placeholder_id = max(self.graph.vertices(), default=0) + 1
        proto = {r.vtype.name: r.estimate
                 for r in self.graph.vertices().values()}
        for t in by_type_counts:
            vt = self.graph.registry.vertex_types[t]
            for _ in range(self.vertex_chunk):
                g.add_vertex(placeholder_id, vt, proto[t], fixed=True)
                placeholder_id += 1
        edge_counts: dict[str, int] = {}
        for e in self.graph.edges():
            g.add_edge(e.etype, e.vids, e.measurement, e.information,
                       kernel=e.kernel, delta=e.delta, level=e.level,
                       active=e.active, param_id=e.param_id)
            edge_counts[e.etype.name] = edge_counts.get(e.etype.name, 0) + 1
        # guarantee at least one inactive slack row per edge type
        for e in list(self.graph.edges()):
            if edge_counts.get(e.etype.name, 0) % self.edge_chunk == 0:
                g.add_edge(e.etype, e.vids, e.measurement, e.information,
                           kernel=e.kernel, delta=e.delta, level=e.level,
                           active=False, param_id=e.param_id)
                edge_counts[e.etype.name] += 1

        # per-row kernel dispatch: added edges may carry a different robust
        # kernel than the placeholder rows they overwrite
        p = g.compile(dtype=self.dtype, device=self.device,
                      pad_edges_to_multiple=self.edge_chunk,
                      static_kernels=False)
        self._problem = p
        self._est_host = None
        self._fixed_host = {t: f.cpu().numpy().copy()
                            for t, f in p.data.fixed.items()}
        # live vertices come first within each type (their ids sort before
        # the placeholders'): count them by scanning vid_index for real ids
        self._live_counts = {t: 0 for t in p.counts}
        for vid, (t, i) in p.vid_index.items():
            if vid in self.graph.vertices():
                self._live_counts[t] += 1
        # level != 0 edges are excluded from the compiled batch, so they
        # must not advance the in-place write cursor either
        self._live_edges = {name: sum(1 for e in self.graph.edges()
                                      if e.etype.name == name
                                      and e.level == 0)
                            for name in p.edge_types}
        self._recompiles += 1
        self._edges_dirty = False
        solver = self._solver_factory()
        self._opt = SparseOptimizer(p, algorithm=self._algorithm_factory(),
                                    solver=solver, verbose=self.verbose)

    # ------------------------------------------------------------------ #

    @property
    def problem(self):
        if self._problem is None:
            self._compile()
        return self._problem

    @property
    def recompiles(self):
        return self._recompiles

    def chi2(self):
        if self._problem is None:
            self._compile()
        return self._opt.chi2()

    def _refresh_structure(self):
        """Give the solver the structure of the rows written since its
        last solve (see the module docstring)."""
        solver = self._opt.solver
        if isinstance(solver, PCGSolver):
            # chunk preconditioners hold edge→chunk index maps built at
            # set-up; rows written since then would feed real blocks
            # through stale placeholder indices.  Jacobi reads no index
            if solver.precond in ("chunk", "chunk2"):
                solver.refresh_chunk_maps(self._problem)
        else:
            # the block pattern / index maps of every other solver come
            # from vidx at set-up
            solver.setup(self._problem, force=True)

    def optimize(self, iterations: int = 5):
        if self._problem is None:
            self._compile()
        self._opt.problem = self._problem
        solver = self._opt.solver
        if self._edges_dirty:
            self._refresh_structure()
        self._edges_dirty = False
        if getattr(solver, "precond_mode", None) == "frozen":
            # warm start: ONE preconditioner build per update; all LM
            # iterations/λ-trials of this update reuse it (the analogue of
            # the reference's cross-update factor reuse,
            # ``g2o_incremental/linear_solver_cholmod_online.h``)
            solver.refresh_precond(self._problem)
        self._est_host = None
        return self._opt.optimize(iterations)

    def get_estimate(self, vid):
        return self.problem.get_estimate(vid)
