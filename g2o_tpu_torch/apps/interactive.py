"""Interactive SLAM protocol server — port of
``g2o_tpu/apps/interactive.py``, the analogue of the reference
``interactive_slam`` executable (``examples/interactive_slam/``): a
stdin/stdout line protocol (``g2o_interactive/protocol.txt``):

    ADD VERTEX_XYT id [x y t];
    ADD EDGE_XYT edge_id id1 id2 x y t ixx ixy ixt iyy iyt itt;
    FIX id;
    SOLVE_STATE;
    QUERY_STATE [ids...];

Responses to QUERY_STATE are ``BEGIN / VERTEX_XYT id x y t ... / END``
blocks.  3D uses VERTEX_XYZRPY / EDGE_XYZRPY with Euler roll-pitch-yaw
measurements, mapped internally onto the quaternion SE3 representation.
The backend is the port's capacity-padded :class:`IncrementalOptimizer`:
new vertices and edges are written in place into the problem's tensors
on ``device`` (the CUDA card unless the caller passes ``device="cpu"``,
``-device cpu`` on the command line), and the problem is only built anew
when a capacity overflows.  It optimizes at every SOLVE_STATE or every
``solve_every`` new edges (the reference's batch-every-N mode)."""

from __future__ import annotations

import sys

import numpy as np
import torch

from g2o_tpu_torch.core.incremental import IncrementalOptimizer
from g2o_tpu_torch.core.types import upper_triangular_to_full
from g2o_tpu_torch.ops import lie


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _rpy_to_quat(rpy):
    r, p, y = (float(v) for v in rpy)
    qx = lie.so3_exp(_t([r, 0, 0]))
    qy = lie.so3_exp(_t([0, p, 0]))
    qz = lie.so3_exp(_t([0, 0, y]))
    q = lie.quat_mul(qz, lie.quat_mul(qy, qx)).numpy()
    return q / np.linalg.norm(q)


def _quat_to_rpy(q):
    R = lie.quat_to_matrix(_t(q)).numpy()
    yaw = np.arctan2(R[1, 0], R[0, 0])
    pitch = np.arcsin(np.clip(-R[2, 0], -1, 1))
    roll = np.arctan2(R[2, 1], R[2, 2])
    return np.array([roll, pitch, yaw])


class InteractiveSlam:
    """The protocol's state; the problem is built in ``dtype`` (float64
    when None) on ``device``."""

    def __init__(self, *, iterations: int = 5, solve_every: int = 0,
                 verbose: bool = False, dtype=None, device="cuda"):
        from g2o_tpu_torch.types.slam2d import VertexSE2, EdgeSE2
        from g2o_tpu_torch.types.slam3d import VertexSE3, EdgeSE3

        self._v2, self._e2 = VertexSE2, EdgeSE2
        self._v3, self._e3 = VertexSE3, EdgeSE3
        self.inc = IncrementalOptimizer(verbose=verbose, dtype=dtype,
                                        device=device)
        self.iterations = iterations
        self.solve_every = solve_every
        self._since_solve = 0
        self._dim = {}        # vid -> 2 or 3
        self._has_fixed = False

    # -- commands ------------------------------------------------------- #

    def add_vertex_xyt(self, vid, init=None):
        est = np.asarray(init if init is not None else [0.0, 0, 0])
        # gauge: auto-fix the FIRST vertex added (the reference backend
        # fixes the first vertex, not a hardcoded id 0 — sessions whose
        # ids start elsewhere otherwise run gauge-free/singular)
        autofix = not self._has_fixed and not self._dim
        self.inc.add_vertex(vid, self._v2, est, fixed=autofix)
        self._has_fixed = self._has_fixed or autofix
        self._dim[vid] = 2

    def add_vertex_xyzrpy(self, vid, init=None):
        if init is not None:
            t, rpy = np.asarray(init[:3]), np.asarray(init[3:6])
            est = np.concatenate([t, _rpy_to_quat(rpy)])
        else:
            est = np.array([0, 0, 0, 0, 0, 0, 1.0])
        autofix = not self._has_fixed and not self._dim
        self.inc.add_vertex(vid, self._v3, est, fixed=autofix)
        self._has_fixed = self._has_fixed or autofix
        self._dim[vid] = 3

    def add_edge_xyt(self, eid, id1, id2, meas, info_ut):
        for vid in (id1, id2):
            if vid not in self._dim:
                self.add_vertex_xyt(vid)
        info = upper_triangular_to_full(info_ut, 3)
        self.inc.add_edge(self._e2, [id1, id2], meas, info)
        self._auto_solve()

    def add_edge_xyzrpy(self, eid, id1, id2, meas, info_ut):
        for vid in (id1, id2):
            if vid not in self._dim:
                self.add_vertex_xyzrpy(vid)
        t, rpy = np.asarray(meas[:3]), np.asarray(meas[3:6])
        m = np.concatenate([t, _rpy_to_quat(rpy)])
        # the wire info matrix is over the xyz+rpy parameterization; the
        # EdgeSE3 residual lives in the quaternion tangent — apply the
        # same J^T I J basis change the EDGE3 loader uses
        from g2o_tpu_torch.types.slam3d_addons import _edge3_info_from_io

        info = _edge3_info_from_io(
            upper_triangular_to_full(info_ut, 6), m)
        self.inc.add_edge(self._e3, [id1, id2], m, info)
        self._auto_solve()

    def fix(self, vid):
        self.inc.graph.set_fixed(vid, True)
        self._has_fixed = True
        self.inc._invalidate()

    def solve(self):
        self._since_solve = 0
        return self.inc.optimize(self.iterations)

    def query(self, vids=None):
        out = ["BEGIN"]
        ids = sorted(self._dim) if not vids else sorted(vids)
        for vid in ids:
            est = self.inc.get_estimate(vid)
            if self._dim.get(vid) == 2:
                out.append("VERTEX_XYT %d %.9g %.9g %.9g"
                           % (vid, est[0], est[1], est[2]))
            else:
                rpy = _quat_to_rpy(est[3:7])
                out.append("VERTEX_XYZRPY %d %.9g %.9g %.9g %.9g %.9g %.9g"
                           % (vid, est[0], est[1], est[2],
                              rpy[0], rpy[1], rpy[2]))
        out.append("END")
        return "\n".join(out)

    def _auto_solve(self):
        self._since_solve += 1
        if self.solve_every and self._since_solve >= self.solve_every:
            self.solve()

    # -- protocol loop --------------------------------------------------- #

    def handle_line(self, line: str):
        line = line.strip().rstrip(";").strip()
        if not line or line.startswith("#"):
            return None
        tok = line.split()
        cmd = tok[0].upper()
        if cmd == "ADD":
            kind = tok[1].upper()
            vals = [float(x) for x in tok[3:]]
            if kind == "VERTEX_XYT":
                self.add_vertex_xyt(int(tok[2]), vals if vals else None)
            elif kind == "VERTEX_XYZRPY":
                self.add_vertex_xyzrpy(int(tok[2]), vals if vals else None)
            elif kind == "EDGE_XYT":
                ids = [int(x) for x in tok[3:5]]
                vals = [float(x) for x in tok[5:]]
                self.add_edge_xyt(int(tok[2]), ids[0], ids[1],
                                  vals[:3], vals[3:9])
            elif kind == "EDGE_XYZRPY":
                ids = [int(x) for x in tok[3:5]]
                vals = [float(x) for x in tok[5:]]
                self.add_edge_xyzrpy(int(tok[2]), ids[0], ids[1],
                                     vals[:6], vals[6:27])
            else:
                return f"# error: unknown element {kind}"
            return None
        if cmd == "FIX":
            self.fix(int(tok[1]))
            return None
        if cmd == "SOLVE_STATE":
            self.solve()
            return None
        if cmd == "QUERY_STATE":
            return self.query([int(x) for x in tok[1:]] or None)
        return f"# error: unknown command {cmd}"


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="g2o_tpu_torch-interactive")
    ap.add_argument("-i", "--iterations", type=int, default=5)
    ap.add_argument("-batch", type=int, default=0,
                    help="auto-solve every N added edges")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                    help="device the problem is built on (default: the "
                         "CUDA card; no card is an error, not a CPU run)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass -device cpu to run on the CPU")
    srv = InteractiveSlam(iterations=args.iterations,
                          solve_every=args.batch, verbose=args.verbose,
                          device=args.device)
    for line in sys.stdin:
        resp = srv.handle_line(line)
        if resp is not None:
            print(resp, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
