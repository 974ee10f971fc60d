"""Convert a segment-based 2D graph into a line-based one — port of
``g2o_tpu/apps/convert_segment_line.py``, the counterpart of the
reference ``convertSegmentLine`` tool
(``g2o/apps/g2o_simulator/convertSegmentLine.cpp:110-262``): poses and
odometry edges are copied; every ``VERTEX_SEGMENT2D`` becomes a
``VERTEX_LINE2D`` (same id, supporting-line parameters of its
endpoints); segment observations become line observations plus, for
full-segment measurements, endpoint ``VERTEX_XY`` vertices tied to the
line by ``EDGE_LINE2D_POINTXY`` constraints and observed through
``EDGE_SE2_XY`` edges.

A host graph transform: nothing runs on a device.

Usage: ``python -m g2o_tpu_torch.apps.convert_segment_line [-o out.g2o]
in.g2o``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def line_parameters(p1, p2):
    """(theta, rho) of the supporting line through two points — the
    reference ``computeLineParameters`` (``simutils.cpp:146-153``)."""
    dp = np.asarray(p2, dtype=np.float64) - np.asarray(p1, dtype=np.float64)
    theta = np.arctan2(-dp[0], dp[1])
    n = np.array([np.cos(theta), np.sin(theta)])
    rho = float(n @ ((np.asarray(p1) + np.asarray(p2)) * 0.5))
    return np.array([theta, rho])


def convert(g_in):
    """Return a NEW graph with segments replaced by lines (+ endpoint
    points for full-segment observations)."""
    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.types.slam2d import (EdgeSE2, EdgeSE2PointXY,
                                            VertexPointXY, VertexSE2)
    from g2o_tpu_torch.types.slam2d_addons import (EdgeLine2DPointXY,
                                                   EdgeSE2Line2D,
                                                   VertexLine2D)

    out = Graph()
    seg_est = {}                    # segment vid -> (p1, p2)
    endpoint = {}                   # (segment vid, 0|1) -> point vid
    line_state = {}                 # line vid -> np state (mutable p ids)
    current_id = -1
    first_pose = None
    for vid, rec in sorted(g_in.vertices().items()):
        current_id = max(current_id, vid)
        if rec.vtype is VertexSE2 or rec.vtype.name == "VERTEX_SE2":
            out.add_vertex(vid, VertexSE2, rec.estimate,
                           fixed=(first_pose is None))
            if first_pose is None:
                first_pose = vid
        elif rec.vtype.name == "VERTEX_SEGMENT2D":
            p1, p2 = rec.estimate[0:2], rec.estimate[2:4]
            seg_est[vid] = (p1, p2)
            st = np.concatenate([line_parameters(p1, p2), [-1.0, -1.0]])
            line_state[vid] = st
            out.add_vertex(vid, VertexLine2D, st)
    current_id += 1

    def ensure_endpoint(seg_vid, which):
        nonlocal current_id
        key = (seg_vid, which)
        if key in endpoint:
            return endpoint[key]
        pv = current_id
        current_id += 1
        out.add_vertex(pv, VertexPointXY, seg_est[seg_vid][which])
        endpoint[key] = pv
        line_state[seg_vid][2 + which] = pv
        out.vertex(seg_vid).estimate = line_state[seg_vid]
        # pin the endpoint onto its line (the reference's 1e6-information
        # point-on-line constraint)
        out.add_edge(EdgeLine2DPointXY, [seg_vid, pv], np.zeros(1),
                     np.array([[1e6]]))
        return pv

    for e in g_in.edges():
        name = e.etype.name
        if name == "EDGE_SE2":
            out.add_edge(EdgeSE2, list(e.vids), e.measurement, e.information)
        elif name == "EDGE_SE2_SEGMENT2D_LINE":
            out.add_edge(EdgeSE2Line2D, list(e.vids), e.measurement,
                         e.information)
        elif name == "EDGE_SE2_SEGMENT2D":
            pose, seg = e.vids
            m1, m2 = e.measurement[0:2], e.measurement[2:4]
            out.add_edge(EdgeSE2Line2D, [pose, seg], line_parameters(m1, m2),
                         np.diag([10000.0, 1000.0]))
            si = np.asarray(e.information)
            for which, mp in ((0, m1), (1, m2)):
                pv = ensure_endpoint(seg, which)
                blk = si[2 * which:2 * which + 2, 2 * which:2 * which + 2]
                out.add_edge(EdgeSE2PointXY, [pose, pv], mp, blk)
        elif name in ("EDGE_SE2_SEGMENT2D_POINTLINE",
                      "EDGE_SE2_SEGMENT2D_POINTLINE_P1"):
            pose, seg = e.vids
            which = 0 if name.endswith("POINTLINE") else 1
            theta = float(e.measurement[2])
            n = np.array([np.cos(theta), np.sin(theta)])
            lparams = np.array([theta, float(n @ e.measurement[0:2])])
            si = np.asarray(e.information)
            out.add_edge(EdgeSE2Line2D, [pose, seg], lparams,
                         np.diag([float(si[2, 2]), 1000.0]))
            pv = ensure_endpoint(seg, which)
            out.add_edge(EdgeSE2PointXY, [pose, pv], e.measurement[0:2],
                         si[0:2, 0:2])
    return out


def main(argv=None):
    from g2o_tpu_torch.io import g2o_format

    ap = argparse.ArgumentParser(
        description="convert a segment graph to a line graph "
                    "(reference convertSegmentLine)")
    ap.add_argument("-o", default="", help="output file")
    ap.add_argument("input", help="input .g2o file ('-' for stdin)")
    args = ap.parse_args(argv)
    import g2o_tpu_torch.types  # noqa: F401

    g = g2o_format.load(sys.stdin if args.input == "-" else args.input)
    out = convert(g)
    print(f"{len(out.vertices())} vertices, {len(list(out.edges()))} edges",
          file=sys.stderr)
    if args.o:
        g2o_format.save(out, args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
