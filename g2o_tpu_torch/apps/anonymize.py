"""Anonymize landmark observations / loop closures of a 2D pose graph —
port of ``g2o_tpu/apps/anonymize.py``, the counterpart of the reference
``g2o_anonymize_observations`` tool
(``g2o/apps/g2o_simulator/g2o_anonymize_observations.cpp:40-112``):

* landmark observation edges (``EdgeSE2PointXY`` /
  ``EdgeSE2PointXYOffset`` / ``EdgeSE2PointXYBearing``) get their
  LANDMARK endpoint (slot 1) detached (saved as the reference's
  ``UnassignedId`` = -1, ``optimizable_graph.cpp:964``) — the data
  association is erased while the geometric measurement survives;
* pose-pose edges (``EdgeSE2`` / ``EdgeSE2Offset``) that are LOOP
  CLOSURES (|from - to| > 1) get their higher-id endpoint detached —
  odometry chains stay intact.

A host graph transform: nothing runs on a device.

Usage: ``python -m g2o_tpu_torch.apps.anonymize [-o anon.g2o] input.g2o``
"""

from __future__ import annotations

import argparse
import sys

LANDMARK_EDGES = ("EDGE_SE2_XY", "EDGE_SE2_POINTXY_OFFSET",
                  "EDGE_BEARING_SE2_XY")
POSE_EDGES = ("EDGE_SE2", "EDGE_SE2_OFFSET")


UNASSIGNED = -1    # HyperGraph::UnassignedId


def anonymize(g, *, landmark_edges=LANDMARK_EDGES, pose_edges=POSE_EDGES):
    """Detach observation endpoints of ``g`` in place (see module doc).
    Returns the number of edges anonymized."""
    n = 0
    for e in g.edges():
        name = e.etype.name
        if name in landmark_edges:
            vids = list(e.vids)
            if vids[1] != UNASSIGNED:
                vids[1] = UNASSIGNED
                e.vids = tuple(vids)
                n += 1
        elif name in pose_edges:
            a, b = int(e.vids[0]), int(e.vids[1])
            if a != b and UNASSIGNED not in (a, b) and abs(a - b) > 1:
                vids = list(e.vids)
                vids[0 if a > b else 1] = UNASSIGNED
                e.vids = tuple(vids)
                n += 1
    return n


def main(argv=None):
    from g2o_tpu_torch.io import g2o_format

    ap = argparse.ArgumentParser(
        description="anonymize observations of a 2D graph "
                    "(reference g2o_anonymize_observations)")
    ap.add_argument("-o", default="anon.g2o", help="output file")
    ap.add_argument("input", help="input .g2o file ('-' for stdin)")
    args = ap.parse_args(argv)
    import g2o_tpu_torch.types  # noqa: F401  (register tags)

    g = g2o_format.load(sys.stdin if args.input == "-" else args.input)
    n = anonymize(g)
    print(f"anonymized {n} edges", file=sys.stderr)
    g2o_format.save(g, args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
