"""``.g2o`` text-format reader/writer — port of ``g2o_tpu/io/g2o_format.py``
(pure Python; the reference loader/saver is
``g2o/core/optimizable_graph.cpp:397,681``).

* ``<VERTEX_TAG> id <state floats>``
* ``<EDGE_TAG> id... [param_id...] <meas floats> <upper-triangular info>``
* ``FIX id...`` — pin vertices (gauge)
* ``PARAMS_* id <floats>`` — shared parameter blocks (the deprecated
  library's ``DEPRECATED_PARAMS_*`` spellings too)
* ``<DYNAMIC_TAG> id... || count <meas floats> <info>`` — a
  variable-arity edge (``EDGE_SE2_LOTSOFXY``, ``EDGE_SE3_LOTSOF_XYZ``)
* ``ROBOTLASER1 ...`` and the other ``DATA_TAGS`` — a sensor-data payload,
  kept verbatim on the vertex defined before it

The information matrix is the row-major upper triangle (the EDGE3 6x6
case: 21 numbers).  A type whose ``.g2o`` numbers differ from its stored
ones converts them on read and write (``from_vector`` / ``to_vector``,
``meas_from_vector`` / ``meas_to_vector``, ``info_from_io`` /
``info_to_io``).  Every malformed line raises a ``ValueError`` that names
its line number.
"""

from __future__ import annotations

import io as _io

import numpy as np

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.types import (REGISTRY, full_to_upper_triangular,
                                      upper_triangular_to_full)

# parameter tags written back by length
_PARAM_TAG_BY_LEN = {7: "PARAMS_SE3OFFSET", 3: "PARAMS_SE2OFFSET",
                     11: "PARAMS_CAMERACALIB", 12: "PARAMS_STEREOCAMERACALIB",
                     4: "PARAMS_CAMERAPARAMETERS"}
# the deprecated slam3d library's parameter spellings
# (``types/deprecated/slam3d/types_slam3d.cpp:43,49``)
DEPRECATED_PARAM_TAGS = ("DEPRECATED_PARAMS_SE3OFFSET",
                         "DEPRECATED_PARAMS_CAMERACALIB")
# sensor-data payload tags attached verbatim to the vertex before them
# (reference ``g2o/types/data``: RobotLaser / RawLaser readings)
DATA_TAGS = ("ROBOTLASER1", "ROBOTLASER2", "RAWLASER1", "RAWLASER2",
             "VERTEX_TAG", "VERTEX_ELLIPSE")


def _floats(parts, n, what):
    if len(parts) < n:
        raise ValueError(f"expected {n} {what} entries, got {len(parts)}")
    return np.array([float(x) for x in parts[:n]])


def load(path_or_file, graph: Graph | None = None, registry=None,
         default_fixed=None, rename: dict | None = None) -> Graph:
    """Read a ``.g2o`` file (path or text file object) into a Graph.

    ``default_fixed``: vertex ids to fix when the file has no ``FIX`` line
    (the reference apps' gauge for files such as sphere2500); ids not in
    the file are skipped.  ``rename`` maps tags on disk to registered tags
    before the lookup (the reference CLI's ``-renameTypes``)."""
    registry = registry or REGISTRY
    g = graph or Graph(registry)
    fix_ids = []
    last_vid = None
    fh = path_or_file if hasattr(path_or_file, "read") else \
        open(path_or_file, "r")
    try:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if rename and parts[0] in rename:
                parts[0] = rename[parts[0]]
            try:
                vid = _parse_line(g, registry, parts, line, lineno, fix_ids,
                                  last_vid)
            except (ValueError, KeyError, IndexError) as e:
                raise ValueError(f"line {lineno}: {e}") from e
            if vid is not None:
                last_vid = vid
    finally:
        if fh is not path_or_file:
            fh.close()
    for lineno, vid in fix_ids:
        if vid not in g.vertices():
            raise ValueError(f"line {lineno}: FIX of unknown vertex {vid}")
        g.set_fixed(vid, True)
    if not fix_ids and default_fixed:
        for vid in default_fixed:
            if g.has_vertex(int(vid)):
                g.set_fixed(int(vid), True)
    return g


def _parse_line(g, registry, parts, line, lineno, fix_ids, last_vid):
    """Add the line's record to ``g``; returns the vertex id when the line
    defines a vertex."""
    tag = parts[0]
    if tag == "FIX":
        fix_ids.extend((lineno, int(p)) for p in parts[1:])
        return None
    if tag in DATA_TAGS:
        if last_vid is not None:
            g.add_vertex_data(last_vid, line)
        return None
    if tag.startswith("PARAMS_") or tag in DEPRECATED_PARAM_TAGS:
        g.add_parameter(int(parts[1]), [float(x) for x in parts[2:]])
        return None
    vt = registry.vertex_for_tag(tag)
    if vt is not None:
        vid = int(parts[1])
        vals = _floats(parts[2:], vt.serialized_dim, f"{tag} state")
        if vt.from_vector is not None:
            vals = np.asarray(vt.from_vector(vals))
        g.add_vertex(vid, vt, vals)
        return vid
    dyn = registry.dynamic_edge_for_tag(tag)
    if dyn is not None:
        _parse_dynamic_edge(g, dyn, tag, parts)
        return None
    et = registry.edge_for_tag(tag)
    if et is None:
        raise ValueError(f"unknown tag {tag!r}")
    k = et.num_slots
    vids = [int(p) for p in parts[1:1 + k]]
    if len(vids) != k:
        raise ValueError(f"{tag}: expected {k} vertex ids")
    pos = 1 + k
    param_id = None
    if et.param_dim:
        param_id = tuple(int(parts[pos + i]) for i in range(et.num_params))
        pos += et.num_params
    m = et.serialized_meas_dim
    meas = _floats(parts[pos:], m, f"{tag} measurement")
    pos += m
    if et.meas_from_vector is not None:
        meas = np.asarray(et.meas_from_vector(meas))
    r = et.residual_dim
    ninfo = r * (r + 1) // 2
    # values past the information triangle are ignored, as the reference's
    # per-edge read does
    info = upper_triangular_to_full(
        _floats(parts[pos:], ninfo, f"{tag} information"), r)
    if et.info_from_io is not None:
        info = np.asarray(et.info_from_io(info, meas))
    g.add_edge(et, vids, meas, info, param_id=param_id)
    return None


def _parse_dynamic_edge(g, factory, tag, parts):
    """``TAG id... || count meas info`` (reference
    ``optimizable_graph.cpp:575-590``): the arity-``count`` type."""
    if "||" not in parts:
        raise ValueError(f"{tag} missing '||' separator")
    sep = parts.index("||")
    vids = [int(p) for p in parts[1:sep]]
    count = int(parts[sep + 1])
    if count != len(vids) - 1:
        raise ValueError(f"{tag} count {count} != {len(vids) - 1} observed "
                         f"vertices")
    et = factory(count)
    pos = sep + 2
    meas = _floats(parts[pos:], et.serialized_meas_dim, f"{tag} measurement")
    pos += et.serialized_meas_dim
    r = et.residual_dim
    info = upper_triangular_to_full(
        _floats(parts[pos:], r * (r + 1) // 2, f"{tag} information"), r)
    g.add_edge(et, vids, meas, info)


def loads(text: str, **kw) -> Graph:
    return load(_io.StringIO(text), **kw)


def _fmt(vals) -> str:
    return " ".join(f"{float(v):.10g}" for v in np.asarray(vals).reshape(-1))


def save(g: Graph, path_or_file, estimates_by_vid=None,
         vertex_subset=None, edge_subset=None, level=None):
    """Write the graph, optionally with updated estimates — parameters,
    vertices (+ their payload lines and ``FIX``), then edges, like the
    reference saver.

    The subset forms (reference ``OptimizableGraph::saveSubset``,
    ``g2o/core/optimizable_graph.cpp:719,749``):

    * ``vertex_subset`` (vertex ids): only these vertices, and the edges
      (at ``level``, when given) whose vertices all lie in it;
    * ``edge_subset`` (edge records of ``g.edges()``): these edges and
      exactly the vertices they touch;
    * ``level``: without ``edge_subset``, only the edges of this level."""
    if edge_subset is not None:
        edges = list(edge_subset)
        vset = {v for e in edges for v in e.vids}
    else:
        edges = [e for e in g.edges() if level is None or e.level == level]
        vset = None
        if vertex_subset is not None:
            vset = {int(v) for v in vertex_subset}
            edges = [e for e in edges if all(v in vset for v in e.vids)]
    fh = path_or_file if hasattr(path_or_file, "write") else \
        open(path_or_file, "w")
    try:
        for pid in sorted(g.parameters()):
            vals = g.parameter(pid)
            tag = _PARAM_TAG_BY_LEN.get(len(vals), "PARAMS_UNKNOWN")
            fh.write(f"{tag} {pid} {_fmt(vals)}\n")
        for vid in sorted(g.vertices()):
            if vset is not None and vid not in vset:
                continue
            rec = g.vertices()[vid]
            est = rec.estimate if estimates_by_vid is None \
                else estimates_by_vid[vid]
            if rec.vtype.to_vector is not None:
                est = rec.vtype.to_vector(est)
            fh.write(f"{rec.vtype.io_tags[0]} {vid} {_fmt(est)}\n")
            for raw in g.vertex_data(vid):
                fh.write(raw + "\n")
            if rec.fixed:
                fh.write(f"FIX {vid}\n")
        for e in edges:
            et = e.etype
            meas = e.measurement
            if et.meas_to_vector is not None:
                meas = et.meas_to_vector(meas)
            if et.dynamic_tag:
                fh.write(" ".join([
                    et.dynamic_tag, " ".join(str(v) for v in e.vids),
                    "||", str(len(e.vids) - 1), _fmt(meas),
                    _fmt(full_to_upper_triangular(e.information))]) + "\n")
                continue
            parts = [et.io_tags[0], " ".join(str(v) for v in e.vids)]
            if et.param_dim:
                parts.append(" ".join(str(p) for p in e.param_id))
            parts.append(_fmt(meas))
            info = e.information
            if et.info_to_io is not None:
                info = np.asarray(et.info_to_io(info, e.measurement))
            parts.append(_fmt(full_to_upper_triangular(info)))
            fh.write(" ".join(parts) + "\n")
    finally:
        if fh is not path_or_file:
            fh.close()


def dumps(g: Graph, **kw) -> str:
    buf = _io.StringIO()
    save(g, buf, **kw)
    return buf.getvalue()
