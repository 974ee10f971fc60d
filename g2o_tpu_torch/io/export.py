"""Graph export for plotting/inspection — port of ``g2o_tpu/io/export.py``
(plain numpy on the host, as there), the analogue of the reference
``WriteGnuplotAction`` / ``output_helper`` (``apps/g2o_cli/output_helper.cpp``,
``core/hyper_graph_action.h:167``): gnuplot data dumps and graphviz dot."""

from __future__ import annotations

import numpy as np


def _positions(graph, estimates_by_vid=None):
    est = estimates_by_vid or {vid: r.estimate
                               for vid, r in graph.vertices().items()}
    pos = {}
    for vid, r in graph.vertices().items():
        e = np.asarray(est[vid])
        if r.vtype.name in ("VERTEX_SE2",):
            pos[vid] = e[:2]
        elif e.shape[0] >= 3:
            pos[vid] = e[:3]
        else:
            pos[vid] = e[:2]
    return pos


def write_gnuplot(graph, path, estimates_by_vid=None):
    """Edges as gnuplot line segments (blank-line separated), vertices
    appended as a point block — loadable with
    ``plot 'file' index 0 w l, '' index 1 w p``."""
    pos = _positions(graph, estimates_by_vid)
    with open(path, "w") as fh:
        fh.write("# edges\n")
        for e in graph.edges():
            pts = [pos[v] for v in e.vids if v in pos]
            if len(pts) < 2:
                continue
            for p in pts:
                fh.write(" ".join(f"{x:.8g}" for x in p) + "\n")
            fh.write("\n")
        fh.write("\n# vertices\n")
        for vid in sorted(pos):
            fh.write(" ".join(f"{x:.8g}" for x in pos[vid]) + "\n")


def write_dot(graph, path, max_edges: int | None = None):
    """Graphviz dot of the hyper-graph structure (vertex type as shape
    label, edge type as edge label)."""
    with open(path, "w") as fh:
        fh.write("graph g2o {\n  node [shape=circle, fontsize=8];\n")
        for vid, r in graph.vertices().items():
            style = ' style=filled fillcolor=lightgray' if r.fixed else ""
            fh.write(f'  v{vid} [label="{vid}\\n{r.vtype.name}"{style}];\n')
        for i, e in enumerate(graph.edges()):
            if max_edges is not None and i >= max_edges:
                fh.write(f"  // ... {graph.num_edges - max_edges} more\n")
                break
            vids = list(e.vids)
            if len(vids) == 2:
                fh.write(f'  v{vids[0]} -- v{vids[1]} '
                         f'[label="{e.etype.name}", fontsize=6];\n')
            else:
                hub = f"e{i}"
                fh.write(f'  {hub} [shape=point];\n')
                for v in vids:
                    fh.write(f"  v{v} -- {hub};\n")
        fh.write("}\n")
