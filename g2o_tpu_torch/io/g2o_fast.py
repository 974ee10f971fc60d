"""Array-direct ``.g2o`` loading — port of ``g2o_tpu/io/g2o_fast.py``:
the native C++ tokenizer (``native/fastparse.cpp``) → numpy blocks →
:func:`~g2o_tpu_torch.core.problem.build_problem`, with no per-record
Python objects.  It is the loader for large files; the object loader
(:mod:`g2o_tpu_torch.io.g2o_format`) takes over when the native library
cannot be built.

Parsing and block assembly run on the host; the ``Problem`` is built on
``device`` (the CUDA card unless the caller passes ``device="cpu"``)."""

from __future__ import annotations

import sys

import numpy as np

from g2o_tpu_torch import native
from g2o_tpu_torch.core.problem import build_problem
from g2o_tpu_torch.core.types import REGISTRY
from g2o_tpu_torch.io.g2o_format import DATA_TAGS, DEPRECATED_PARAM_TAGS
from g2o_tpu_torch.ops import robust as robust_mod


def _object_load(path, *, registry, dtype, device, kernel, delta,
                 marginalize, fix_first_if_free, pad_edges_to_multiple):
    """The same problem through the object loader (no compiler)."""
    from g2o_tpu_torch.io import g2o_format

    print("g2o_tpu_torch.io.g2o_fast: native tokenizer unavailable; using "
          "the object loader", file=sys.stderr)
    g = g2o_format.load(path, registry=registry)
    if kernel:
        g.set_robust_kernel(kernel, delta)
    if marginalize:
        max_dim = max(r.vtype.tangent_dim for r in g.vertices().values())
        for vid, r in g.vertices().items():
            if r.vtype.tangent_dim != max_dim:
                g.set_marginalized(vid, True)
    if fix_first_if_free and not any(r.fixed for r in g.vertices().values()):
        g.set_fixed(min(g.vertices()), True)
    return g.compile(dtype=dtype, device=device,
                     pad_edges_to_multiple=pad_edges_to_multiple), {}


def _concat(prev, new):
    """Append the arrays of ``new`` to those of ``prev`` (``None`` stays
    ``None``): two on-disk tags resolving to one type, e.g. a modern tag
    and its deprecated alias, form one block."""
    if prev is None:
        return new
    return tuple(None if a is None else np.concatenate([a, b])
                 for a, b in zip(prev, new))


def load_problem(path, *, registry=None, dtype=None, device="cuda",
                 kernel=None, delta: float = 1.0, marginalize: bool = False,
                 fix_first_if_free: bool = True,
                 pad_edges_to_multiple: int = 1):
    """Load a ``.g2o`` file straight into a compiled Problem.

    Returns ``(problem, aux)``; ``aux["params"]`` maps parameter ids to
    their values.  Robust kernels are applied uniformly through ``kernel=``
    (the CLI flow); per-edge kernels need the object loader.  Sensor-data
    payloads (``DATA_TAGS``) are dropped.  Without a ``FIX`` line the
    lowest id of the type with the largest tangent dimension is fixed
    (``fix_first_if_free``)."""
    registry = registry or REGISTRY
    blocks = native.parse_blocks(path)
    if blocks is None:
        return _object_load(
            path, registry=registry, dtype=dtype, device=device,
            kernel=kernel, delta=delta, marginalize=marginalize,
            fix_first_if_free=fix_first_if_free,
            pad_edges_to_multiple=pad_edges_to_multiple)

    params = {}
    fixed_ids = np.zeros(0, dtype=np.int64)
    vertex_blocks = {}          # type name -> (ids, estimates)
    edge_blocks = {}            # type name -> (vids, meas, info, pids)
    kid = robust_mod.KERNEL_IDS[kernel] if isinstance(kernel, str) else \
        (kernel or robust_mod.NONE)

    for tag, (vals, ncols) in blocks.items():
        if tag == "FIX":
            fixed_ids = vals[np.isfinite(vals)].astype(np.int64).ravel()
            continue
        if tag in DATA_TAGS:
            continue
        if tag.startswith("PARAMS_") or tag in DEPRECATED_PARAM_TAGS:
            for row, n in zip(vals, ncols):
                params[int(row[0])] = row[1:n].copy()
            continue
        vt = registry.vertex_for_tag(tag)
        if vt is not None:
            ids = vals[:, 0].astype(np.int64)
            est = vals[:, 1:1 + vt.serialized_dim]
            if vt.from_vector is not None:
                est = np.stack([np.asarray(vt.from_vector(row))
                                for row in est])
            vertex_blocks[vt.name] = _concat(vertex_blocks.get(vt.name),
                                             (ids, est))
            continue
        et = registry.edge_for_tag(tag)
        if et is None:
            raise ValueError(f"unknown tag {tag!r} in {path}")
        k = et.num_slots
        vids = vals[:, :k].astype(np.int64)
        pos = k
        pids = None
        if et.param_dim:
            pids = vals[:, pos:pos + et.num_params].astype(np.int64)
            pos += et.num_params
        m = et.serialized_meas_dim
        meas = vals[:, pos:pos + m]
        pos += m
        if et.meas_from_vector is not None:
            meas = np.stack([np.asarray(et.meas_from_vector(row))
                             for row in meas])
        r = et.residual_dim
        tri = vals[:, pos:pos + r * (r + 1) // 2]
        iu = np.triu_indices(r)
        info = np.zeros((len(vals), r, r))
        info[:, iu[0], iu[1]] = tri
        info[:, iu[1], iu[0]] = tri
        if et.info_from_io is not None:
            # the file's information basis to the residual's, line by
            # line as the object loader does (the EDGE3 Euler transform)
            info = np.stack([np.asarray(et.info_from_io(I, mm))
                             for I, mm in zip(info, meas)])
        edge_blocks[et.name] = _concat(edge_blocks.get(et.name),
                                       (vids, meas, info, pids))

    final_edges = {}
    for name, (vids, meas, info, pids) in edge_blocks.items():
        et = registry.edge_types[name]
        E = len(vids)
        pvals = np.zeros((E, et.param_dim))
        if et.param_dim:
            # parameters are few: resolve each unique id tuple once
            keys = [tuple(row) for row in pids]
            lut = {u: np.concatenate([params[int(q)] for q in u])
                   for u in sorted(set(keys))}
            for i, kk in enumerate(keys):
                pvals[i] = lut[kk]
        final_edges[name] = (vids, meas, info,
                             np.full(E, kid, dtype=np.int32),
                             np.full(E, float(delta)),
                             np.ones(E, dtype=bool), pvals)

    fixed_set = {int(x) for x in fixed_ids}
    tdim = {t: registry.vertex_types[t].tangent_dim for t in vertex_blocks}
    first_vid = None
    if vertex_blocks and fix_first_if_free and not fixed_set:
        # the gauge: the lowest id of the LARGEST-tangent type (fixing a
        # 3-dof landmark would leave a rotational gauge freedom; the
        # reference's findGauge picks a pose)
        dmax = max(tdim.values())
        first_vid = int(min(int(ids.min())
                            for t, (ids, _) in vertex_blocks.items()
                            if tdim[t] == dmax and len(ids)))
    max_dim = max(tdim.values(), default=0)
    final_vertices = {}
    for t, (ids, est) in vertex_blocks.items():
        fx = np.array([int(i) in fixed_set for i in ids], dtype=bool)
        if first_vid is not None:
            fx |= ids == first_vid
        mg = np.full(len(ids), marginalize and tdim[t] != max_dim,
                     dtype=bool)
        final_vertices[t] = (ids, est, fx, mg)

    problem = build_problem(final_vertices, final_edges, dtype=dtype,
                            device=device,
                            pad_edges_to_multiple=pad_edges_to_multiple,
                            registry=registry)
    return problem, {"params": params}
