"""Graph format conversion — port of ``examples/data_convert.py``, the
analogue of the reference ``examples/data_convert/convert_sba_slam3d.cpp``:
rewrite an SBA graph (VERTEX_CAM + EDGE_PROJECT_P2SC) as a slam3d graph
(VERTEX_SE3:QUAT + VERTEX_TRACKXYZ + EDGE_PROJECT_DISPARITY with a
PARAMS_CAMERACALIB block), converting stereo (u, v, u_right) measurements
into (u, v, disparity/(fx*b)).  A host graph transform; ``-device`` is
accepted and has nothing to place.

Run: python -m g2o_tpu_torch.examples.data_convert input_sba.g2o
     output_slam3d.g2o
(with no arguments, a synthetic SBA graph is generated, converted, and both
are verified to round-trip through the .g2o reader)
"""

import sys

import numpy as np

from g2o_tpu_torch.examples import split_device


def convert(g_in):
    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.types.slam3d import (
        EdgeSE3PointXYZDisparity, VertexPointXYZ, VertexSE3,
    )

    g_out = Graph()
    fx = baseline = None
    for vid, rec in sorted(g_in.vertices().items()):
        if rec.vtype.name == "VERTEX_CAM":
            st = np.asarray(rec.estimate)
            if fx is None:
                fx, fy, cx, cy = st[7], st[8], st[9], st[10]
                baseline = st[11]
                # PARAMS_CAMERACALIB: offset pose (identity) + K
                g_out.add_parameter(0, np.concatenate(
                    [[0, 0, 0, 0, 0, 0, 1.0], [fx, fy, cx, cy]]))
            g_out.add_vertex(vid, VertexSE3, st[:7], fixed=rec.fixed)
        elif rec.vtype.name in ("VERTEX_TRACKXYZ", "VERTEX_XYZ"):
            g_out.add_vertex(vid, VertexPointXYZ, rec.estimate,
                             fixed=rec.fixed, marginalized=rec.marginalized)
    for e in g_in.edges():
        if e.etype.name != "EDGE_PROJECT_P2SC":
            continue
        point_vid, cam_vid = e.vids
        u, v, ur = np.asarray(e.measurement)
        meas = np.array([u, v, (u - ur) / (fx * baseline)])
        g_out.add_edge(EdgeSE3PointXYZDisparity, [cam_vid, point_vid], meas,
                       np.asarray(e.information), param_id=0)
    return g_out


def make_synthetic_sba():
    from g2o_tpu_torch.examples import sba_demo

    g, _ = sba_demo.make_rig(stereo=True, pixel_noise=0.5)
    return g


def main(argv=None):
    _, args = split_device(argv)
    import g2o_tpu_torch.types  # noqa: F401  (register tags)
    from g2o_tpu_torch.io import g2o_format

    if len(args) >= 2:
        g_in = g2o_format.load(args[0])
        out = args[1]
    else:
        print("no input: converting a synthetic stereo SBA rig")
        g_in = make_synthetic_sba()
        out = "converted_slam3d.g2o"

    g_out = convert(g_in)
    g2o_format.save(g_out, out)
    print(f"wrote {out}: {len(g_out.vertices())} vertices, "
          f"{len(g_out.edges())} edges")
    # verify the output round-trips
    g_back = g2o_format.load(out)
    assert len(g_back.vertices()) == len(g_out.vertices())
    assert len(g_back.edges()) == len(g_out.edges())
    print("round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
