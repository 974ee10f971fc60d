"""``.g2o`` text-format reader/writer — port of ``g2o_tpu/io/g2o_format.py``
(pure Python; the reference loader/saver is
``g2o/core/optimizable_graph.cpp:397,681``).

* ``<VERTEX_TAG> id <state floats>``
* ``<EDGE_TAG> id... [param_id...] <meas floats> <upper-triangular info>``
* ``FIX id...`` — pin vertices (gauge)
* ``PARAMS_* id <floats>`` — shared parameter blocks
* ``<DYNAMIC_TAG> id... || count <meas floats> <info>`` — a
  variable-arity edge (``EDGE_SE2_LOTSOFXY``)

The information matrix is the row-major upper triangle (the EDGE3 6x6
case: 21 numbers).  Every malformed line raises a ``ValueError`` that
names its line number.
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


def _floats(parts, n, what):
    if len(parts) < n:
        raise ValueError(f"expected {n} {what} entries, got {len(parts)}")
    return np.array([float(x) for x in parts[:n]])


def load(path_or_file, graph: Graph | None = None, registry=None) -> Graph:
    """Read a ``.g2o`` file (path or text file object) into a Graph."""
    registry = registry or REGISTRY
    g = graph or Graph(registry)
    fix_ids = []
    fh = path_or_file if hasattr(path_or_file, "read") else \
        open(path_or_file, "r")
    try:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                _parse_line(g, registry, line.split(), lineno, fix_ids)
            except (ValueError, KeyError, IndexError) as e:
                raise ValueError(f"line {lineno}: {e}") from e
    finally:
        if fh is not path_or_file:
            fh.close()
    for lineno, vid in fix_ids:
        if vid not in g.vertices():
            raise ValueError(f"line {lineno}: FIX of unknown vertex {vid}")
        g.set_fixed(vid, True)
    return g


def _parse_line(g, registry, parts, lineno, fix_ids):
    tag = parts[0]
    if tag == "FIX":
        fix_ids.extend((lineno, int(p)) for p in parts[1:])
        return
    if tag.startswith("PARAMS_"):
        g.add_parameter(int(parts[1]), [float(x) for x in parts[2:]])
        return
    vt = registry.vertex_for_tag(tag)
    if vt is not None:
        g.add_vertex(int(parts[1]), vt,
                     _floats(parts[2:], vt.rep_dim, f"{tag} state"))
        return
    dyn = registry.dynamic_edge_for_tag(tag)
    if dyn is not None:
        _parse_dynamic_edge(g, dyn, tag, parts)
        return
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
    meas = _floats(parts[pos:], et.meas_dim, f"{tag} measurement")
    pos += et.meas_dim
    r = et.residual_dim
    ninfo = r * (r + 1) // 2
    # values past the information triangle are ignored, as the reference's
    # per-edge read does
    info = upper_triangular_to_full(
        _floats(parts[pos:], ninfo, f"{tag} information"), r)
    g.add_edge(et, vids, meas, info, param_id=param_id)


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
    meas = _floats(parts[pos:], et.meas_dim, f"{tag} measurement")
    pos += et.meas_dim
    r = et.residual_dim
    info = upper_triangular_to_full(
        _floats(parts[pos:], r * (r + 1) // 2, f"{tag} information"), r)
    g.add_edge(et, vids, meas, info)


def loads(text: str, **kw) -> Graph:
    return load(_io.StringIO(text), **kw)


def _fmt(vals) -> str:
    return " ".join(f"{float(v):.10g}" for v in np.asarray(vals).reshape(-1))


def save(g: Graph, path_or_file, estimates_by_vid=None):
    """Write the graph, optionally with updated estimates — parameters,
    vertices (+ ``FIX``), then edges, like the reference saver."""
    fh = path_or_file if hasattr(path_or_file, "write") else \
        open(path_or_file, "w")
    try:
        for pid in sorted(g.parameters()):
            vals = g.parameter(pid)
            tag = _PARAM_TAG_BY_LEN.get(len(vals), "PARAMS_UNKNOWN")
            fh.write(f"{tag} {pid} {_fmt(vals)}\n")
        for vid in sorted(g.vertices()):
            rec = g.vertices()[vid]
            est = rec.estimate if estimates_by_vid is None \
                else estimates_by_vid[vid]
            fh.write(f"{rec.vtype.io_tags[0]} {vid} {_fmt(est)}\n")
            if rec.fixed:
                fh.write(f"FIX {vid}\n")
        for e in g.edges():
            if e.etype.dynamic_tag:
                fh.write(" ".join([
                    e.etype.dynamic_tag, " ".join(str(v) for v in e.vids),
                    "||", str(len(e.vids) - 1), _fmt(e.measurement),
                    _fmt(full_to_upper_triangular(e.information))]) + "\n")
                continue
            parts = [e.etype.io_tags[0], " ".join(str(v) for v in e.vids)]
            if e.etype.param_dim:
                parts.append(" ".join(str(p) for p in e.param_id))
            parts.append(_fmt(e.measurement))
            parts.append(_fmt(full_to_upper_triangular(e.information)))
            fh.write(" ".join(parts) + "\n")
    finally:
        if fh is not path_or_file:
            fh.close()


def dumps(g: Graph, **kw) -> str:
    buf = _io.StringIO()
    save(g, buf, **kw)
    return buf.getvalue()
