"""Port parity: the ``.g2o`` loader and saver parts of this slice against
the JAX package's ``g2o_format``, on the CPU.

* the port registers every tag the JAX package registers (the per-arity
  types of the variable-arity edges aside, which each package makes on
  first use);
* the graphs of every type library — SE3 with offsets and cameras, plane
  and line landmarks, ``VERTEX3`` / ``EDGE3``, Sim3, segments and 2D
  lines, sensor calibration, GICP — written by the JAX package, read by
  the port and written again: the same bytes;
* ``from_vector`` / ``meas_from_vector`` / ``info_from_io`` on read and
  their inverses on write, the data payload lines, the deprecated
  parameter spellings, ``load(default_fixed=, rename=)`` and
  ``save(vertex_subset=, edge_subset=, level=)``: the port's text equals
  the JAX package's;
* malformed lines of the new kinds raise line-numbered ``ValueError``\\ s.
"""

import re

import numpy as np
import pytest

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch.types  # noqa: F401
import test_torch_addon_types as addon_t
import test_torch_sim3 as sim3_t
import test_torch_slam3d_types as slam3d_t
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.types import REGISTRY as JREG
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.types import slam2d as jslam2d
from g2o_tpu_torch.core.types import REGISTRY as TREG
from g2o_tpu_torch.io import g2o_format as tio

# the per-arity types of EDGE_SE2_LOTSOFXY / EDGE_SE3_LOTSOF_XYZ
_PER_ARITY = re.compile(r"_LOTSOF_?XYZ?_\d+$")


def test_known_tags_equal_jax():
    def tags(reg):
        return {t for t in reg.known_tags() if not _PER_ARITY.search(t)}

    assert tags(TREG) == tags(JREG)
    assert len(tags(TREG)) == 84
    assert TREG.dynamic_edge_for_tag("EDGE_SE3_LOTSOF_XYZ") is not None
    with pytest.raises(KeyError):
        TREG.alias_tag("SOME_ALIAS", "NOT_A_TAG")


GRAPHS = {
    "slam3d": lambda: slam3d_t._random_graph(JGraph, slam3d_t.jslam3d,
                                             slam3d_t.jadd),
    "addons2d": lambda: addon_t._random_graph(JGraph, addon_t.J),
    "sim3": lambda: sim3_t._sim3_graph(JGraph, sim3_t.jsim3,
                                       sim3_t.jslam3d),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_every_library_round_trips_byte_for_byte(name):
    jg = GRAPHS[name]()
    jg.set_fixed(min(jg.vertices()), True)
    text = jio.dumps(jg)
    tg = tio.loads(text)
    assert tio.dumps(tg) == jio.dumps(jio.loads(text))
    assert tg.num_vertices == jg.num_vertices
    assert tg.num_edges == jg.num_edges
    assert [e.etype.name for e in tg.edges()] == \
        [e.etype.name for e in jg.edges()]
    for a, b in zip(tg.edges(), jio.loads(text).edges()):
        assert a.param_id == b.param_id


def _small_graph(G, sl2):
    """Five SE2 poses, two points, edges at levels 0 and 1, a payload."""
    g = G()
    for i in range(5):
        g.add_vertex(i, sl2.VertexSE2, [i, 0.1 * i, 0.05 * i])
    g.add_vertex(10, sl2.VertexPointXY, [1.0, 2.0])
    g.add_vertex(11, sl2.VertexPointXY, [3.0, -1.0])
    g.set_fixed(0, True)
    g.add_vertex_data(2, "RAWLASER1 0 1 2 3")
    for i in range(4):
        g.add_edge(sl2.EdgeSE2, [i, i + 1], [1.0, 0.1, 0.05], np.eye(3),
                   level=i % 2)
    g.add_edge(sl2.EdgeSE2PointXY, [1, 10], [0.5, 1.5], np.eye(2))
    g.add_edge(sl2.EdgeSE2PointXY, [3, 11], [0.2, -1.0], np.eye(2), level=1)
    g.add_edge(sl2.EdgeSE2, [0, 4], [4.0, 0.4, 0.2], np.eye(3), level=1)
    return g


@pytest.mark.parametrize("kw", [
    dict(), dict(level=0), dict(level=1), dict(vertex_subset=[0, 1, 2, 10]),
    dict(vertex_subset=[1, 2, 3, 11], level=1), dict(edge_subset=[1, 4])],
    ids=["all", "level0", "level1", "vertices", "vertices_level1", "edges"])
def test_save_subsets_match_jax(kw):
    jg = _small_graph(JGraph, jslam2d)
    tg = tio.loads(jio.dumps(jg))
    for e_t, e_j in zip(tg.edges(), jg.edges()):
        e_t.level = e_j.level
    if "edge_subset" in kw:
        ks = kw["edge_subset"]
        jkw = dict(edge_subset=[jg.edges()[k] for k in ks])
        tkw = dict(edge_subset=[tg.edges()[k] for k in ks])
    else:
        jkw = tkw = kw
    got, want = tio.dumps(tg, **tkw), jio.dumps(jg, **jkw)
    assert got == want
    if kw:
        assert len(got) < len(jio.dumps(jg))


_NO_FIX = ("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\nVERTEX_XY 7 1 1\n"
           "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n")


@pytest.mark.parametrize("text,default", [
    (_NO_FIX, {0}), (_NO_FIX, {1, 99}), (_NO_FIX, None),
    (_NO_FIX + "FIX 1\n", {0})], ids=["fix0", "fix1_unknown99", "none",
                                      "file_fix_wins"])
def test_load_default_fixed_matches_jax(text, default):
    tg = tio.loads(text, default_fixed=default)
    jg = jio.loads(text, default_fixed=default)
    assert {v for v, r in tg.vertices().items() if r.fixed} == \
        {v for v, r in jg.vertices().items() if r.fixed}
    assert tio.dumps(tg) == jio.dumps(jg)


def test_load_rename_matches_jax():
    text = ("MY_POSE 0 0 0 0\nMY_POSE 1 1 0.5 0.1\nFIX 0\n"
            "MY_ODOM 0 1 1 0.5 0.1 1 0 0 1 0 1\n")
    rename = {"MY_POSE": "VERTEX_SE2", "MY_ODOM": "EDGE_SE2"}
    tg, jg = tio.loads(text, rename=rename), jio.loads(text, rename=rename)
    assert tio.dumps(tg) == jio.dumps(jg)
    assert [r.vtype.name for r in tg.vertices().values()] == ["VERTEX_SE2"] * 2
    with pytest.raises(ValueError, match="line 1"):
        tio.loads(text)


def test_data_tags_attach_to_the_vertex_before_them():
    lines = [f"{tag} 1 2 3" for tag in tio.DATA_TAGS]
    text = "\n".join(["VERTEX_SE2 0 0 0 0", *lines, "VERTEX_XY 5 1 1",
                      lines[0]]) + "\n"
    tg, jg = tio.loads(text), jio.loads(text)
    assert tio.DATA_TAGS == jio.DATA_TAGS
    assert tg.vertex_data(0) == jg.vertex_data(0) == lines
    assert tg.vertex_data(5) == [lines[0]]
    assert tio.dumps(tg) == jio.dumps(jg)


def test_parameter_tags_by_length_match_jax():
    text = "\n".join([
        "PARAMS_SE2OFFSET 1 0.1 0.2 0.3",
        "PARAMS_CAMERAPARAMETERS 2 500 320 240 0.1",
        "DEPRECATED_PARAMS_SE3OFFSET 3 0 0 0 0 0 0 1",
        "DEPRECATED_PARAMS_CAMERACALIB 4 0 0 0 0 0 0 1 300 300 160 120",
        "PARAMS_STEREOCAMERACALIB 5 0 0 0 0 0 0 1 300 300 160 120 0.1",
        "PARAMS_ODD 6 1 2 3 4 5",
    ]) + "\n"
    tg, jg = tio.loads(text), jio.loads(text)
    assert tio.dumps(tg) == jio.dumps(jg)
    assert "PARAMS_UNKNOWN 6" in tio.dumps(tg)


@pytest.mark.parametrize("line,what", [
    ("VERTEX3 0 1 2 3 0.1 0.2", "expected 6"),
    ("VERTEX_SIM3:EXPMAP 0 1 2 3", "expected 11"),
    ("EDGE3 0 1 1 2 3 0 0 0 1 0 0", "information"),
    ("EDGE_SE3_OFFSET 0 1 7", "index"),
    ("EDGE_SE3_LOTSOF_XYZ 0 1 2 || 3 1 2 3 4 5 6", "count"),
], ids=["vertex3", "sim3", "edge3_info", "offset_params", "lotsof_count"])
def test_malformed_new_lines_raise_with_line_number(line, what):
    text = ("VERTEX3 0 0 0 0 0 0 0\nVERTEX3 1 1 0 0 0 0 0\n"
            "VERTEX_SE3:QUAT 5 0 0 0 0 0 0 1\n" + line + "\n")
    with pytest.raises(ValueError, match=r"line 4") as err:
        tio.loads(text)
    assert re.search(what, str(err.value)), str(err.value)
