"""Static + HTML graph rendering — port of ``g2o_tpu/io/viz.py``: the no-GUI
counterpart of the viewer's
draw-action registry (``g2o/apps/g2o_viewer``,
``core/hyper_graph_action.h:137`` ``HyperGraphElementAction``; per-type
``*DrawAction`` classes in the type libraries).

Where the reference registers an OpenGL draw action per element type, this
module renders the same content — vertices as points (fixed ones
highlighted), edges as segments, optionally colored by per-edge chi2 — to

* a static image (PNG/SVG/PDF via matplotlib, 2D or 3D), or
* a standalone interactive HTML file (embedded JSON + a small pan/zoom
  canvas — no server, no external assets).

Positions come from :func:`g2o_tpu_torch.io.export._positions`
(SE2/SE3/XY/XYZ translation components).  Only :func:`render_graph`
needs matplotlib, imported when it is called; the HTML renderers need
nothing past numpy."""

from __future__ import annotations

import json

import numpy as np

from g2o_tpu_torch.io.export import _positions


def _collect(graph, estimates_by_vid=None, chi2_by_edge=None):
    """Vertex position array, edge segment index pairs, edge colors."""
    pos = _positions(graph, estimates_by_vid)
    vids = sorted(pos)
    index = {v: i for i, v in enumerate(vids)}
    dim = max(len(pos[v]) for v in vids) if vids else 2
    P = np.zeros((len(vids), dim))
    for v, i in index.items():
        p = np.asarray(pos[v], dtype=float)
        P[i, :len(p)] = p
    fixed = np.array([graph.vertices()[v].fixed for v in vids], dtype=bool)

    segs, vals = [], []
    for k, e in enumerate(graph.edges()):
        ids = [index[v] for v in e.vids if v in index]
        c = None
        if chi2_by_edge is not None:
            c = float(chi2_by_edge[k])
        # hyper-edges draw as a star from the first vertex
        for b in ids[1:]:
            segs.append((ids[0], b))
            vals.append(0.0 if c is None else c)
    return P, np.asarray(segs, dtype=np.int64).reshape(-1, 2), \
        np.asarray(vals), fixed, vids


def edge_chi2_values(problem):
    """Per-edge robust chi2 in ``graph.edges()`` order is not tracked by
    the compiled problem; this returns the concatenated per-type arrays —
    use with graphs compiled from a single edge type, or pass explicit
    values to :func:`render_graph`."""
    ech = problem.edge_chi2_fn(problem.data, problem.estimates)
    return np.concatenate([v.detach().cpu().numpy() for v in ech.values()])


def render_graph(graph, path, estimates_by_vid=None, *,
                 chi2_by_edge=None, title=None, dpi=130,
                 edge_color="#3b6ea5", vertex_color="#222222",
                 fixed_color="#d62728", linewidth=0.5, markersize=2.0):
    """Render the graph to a static image (format from the extension:
    .png/.svg/.pdf).  ``chi2_by_edge`` (len == #edges) colors edges on a
    viridis scale — the analogue of error-colored viewer drawing."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "render_graph (the CLI's -plot) needs matplotlib, which is not "
            "installed; -htmlPlot and -replayHtml need nothing past "
            "numpy") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    P, segs, vals, fixed, _ = _collect(graph, estimates_by_vid,
                                       chi2_by_edge)
    is3d = P.shape[1] >= 3 and np.abs(P[:, 2]).max() > 1e-9

    fig = plt.figure(figsize=(8, 8))
    if is3d:
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        ax = fig.add_subplot(projection="3d")
        lines = P[segs][:, :, :3]
        lc = Line3DCollection(lines, linewidths=linewidth)
    else:
        from matplotlib.collections import LineCollection

        ax = fig.add_subplot()
        ax.set_aspect("equal")
        lines = P[segs][:, :, :2]
        lc = LineCollection(lines, linewidths=linewidth)
    if chi2_by_edge is not None and len(vals):
        lc.set_array(vals)
        lc.set_cmap("viridis")
        fig.colorbar(lc, ax=ax, label="edge chi2", shrink=0.7)
    else:
        lc.set_color(edge_color)
    ax.add_collection(lc)
    free = ~fixed
    if is3d:
        ax.scatter(P[free, 0], P[free, 1], P[free, 2], s=markersize,
                   c=vertex_color, depthshade=False)
        if fixed.any():
            ax.scatter(P[fixed, 0], P[fixed, 1], P[fixed, 2],
                       s=6 * markersize, c=fixed_color, marker="s",
                       depthshade=False)
        # matching axis spans (matplotlib 3d has no set_aspect equal)
        ctr = P.mean(axis=0)
        r = max((P.max(axis=0) - P.min(axis=0)).max() / 2, 1e-6)
        ax.set_xlim(ctr[0] - r, ctr[0] + r)
        ax.set_ylim(ctr[1] - r, ctr[1] + r)
        ax.set_zlim(ctr[2] - r, ctr[2] + r)
    else:
        ax.plot(P[free, 0], P[free, 1], ".", ms=markersize,
                color=vertex_color)
        if fixed.any():
            ax.plot(P[fixed, 0], P[fixed, 1], "s", ms=3 * markersize,
                    color=fixed_color)
        ax.autoscale()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin: 0; font: 13px sans-serif; }}
 #hud {{ position: fixed; top: 8px; left: 8px; background: #fffc;
        padding: 4px 8px; border-radius: 4px; }}
 canvas {{ display: block; }}
</style></head><body>
<div id="hud">{title} — {nv} vertices, {ne} edges.
 drag to pan, wheel to zoom, double-click to reset</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let tx=0, ty=0, scale=1, drag=null;
function fit() {{
  cv.width = innerWidth; cv.height = innerHeight;
  const xs = DATA.P.map(p=>p[0]), ys = DATA.P.map(p=>p[1]);
  const x0=Math.min(...xs), x1=Math.max(...xs),
        y0=Math.min(...ys), y1=Math.max(...ys);
  const m = 40;
  scale = Math.min((cv.width-2*m)/Math.max(x1-x0,1e-9),
                   (cv.height-2*m)/Math.max(y1-y0,1e-9));
  tx = m - x0*scale + (cv.width-2*m-(x1-x0)*scale)/2;
  ty = cv.height - m + y0*scale - (cv.height-2*m-(y1-y0)*scale)/2;
  draw();
}}
function X(p) {{ return p[0]*scale + tx; }}
function Y(p) {{ return -p[1]*scale + ty; }}
function draw() {{
  ctx.clearRect(0,0,cv.width,cv.height);
  const vmax = DATA.vals.length ? Math.max(...DATA.vals, 1e-12) : 1;
  ctx.lineWidth = 0.7;
  for (let i=0;i<DATA.segs.length;i++) {{
    const [a,b] = DATA.segs[i];
    if (DATA.vals.length) {{
      const t = DATA.vals[i]/vmax;
      ctx.strokeStyle = `rgb(${{40+215*t|0}},${{80+60*(1-t)|0}},${{165*(1-t)|0}})`;
    }} else ctx.strokeStyle = '#3b6ea5';
    ctx.beginPath();
    ctx.moveTo(X(DATA.P[a]), Y(DATA.P[a]));
    ctx.lineTo(X(DATA.P[b]), Y(DATA.P[b]));
    ctx.stroke();
  }}
  ctx.fillStyle = '#222';
  for (let i=0;i<DATA.P.length;i++) {{
    if (DATA.fixed[i]) continue;
    ctx.fillRect(X(DATA.P[i])-1, Y(DATA.P[i])-1, 2, 2);
  }}
  ctx.fillStyle = '#d62728';
  for (let i=0;i<DATA.P.length;i++) {{
    if (!DATA.fixed[i]) continue;
    ctx.fillRect(X(DATA.P[i])-3, Y(DATA.P[i])-3, 6, 6);
  }}
}}
cv.onmousedown = e => drag = [e.clientX - tx, e.clientY - ty];
cv.onmousemove = e => {{ if (drag) {{ tx = e.clientX - drag[0];
  ty = e.clientY - drag[1]; draw(); }} }};
cv.onmouseup = () => drag = null;
cv.ondblclick = fit;
cv.onwheel = e => {{ e.preventDefault();
  const f = Math.exp(-e.deltaY*0.001);
  tx = e.clientX + (tx-e.clientX)*f; ty = e.clientY + (ty-e.clientY)*f;
  scale *= f; draw(); }};
addEventListener('resize', fit);
fit();
</script></body></html>
"""


_REPLAY_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin: 0; font: 13px sans-serif; }}
 #hud {{ position: fixed; top: 8px; left: 8px; background: #fffc;
        padding: 6px 10px; border-radius: 4px; }}
 #hud input[type=range] {{ width: 320px; vertical-align: middle; }}
 canvas {{ display: block; }}
</style></head><body>
<div id="hud"><b>{title}</b> — {nv} vertices, {ne} edges<br>
 <button id="play">&#9654;</button>
 <input type="range" id="frame" min="0" max="{nf_1}" value="0" step="1">
 iteration <span id="it">0</span>/{nf_1} &nbsp;
 chi2 <span id="chi">-</span><br>
 drag to pan, wheel to zoom, double-click to reset</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const slider = document.getElementById('frame');
const itEl = document.getElementById('it'), chiEl = document.getElementById('chi');
let tx=0, ty=0, scale=1, drag=null, f=0, timer=null;
function fit() {{
  cv.width = innerWidth; cv.height = innerHeight;
  let x0=1e30,x1=-1e30,y0=1e30,y1=-1e30;
  for (const P of DATA.frames) for (const p of P) {{
    if (p[0]<x0) x0=p[0]; if (p[0]>x1) x1=p[0];
    if (p[1]<y0) y0=p[1]; if (p[1]>y1) y1=p[1];
  }}
  const m = 40;
  scale = Math.min((cv.width-2*m)/Math.max(x1-x0,1e-9),
                   (cv.height-2*m)/Math.max(y1-y0,1e-9));
  tx = m - x0*scale + (cv.width-2*m-(x1-x0)*scale)/2;
  ty = cv.height - m + y0*scale - (cv.height-2*m-(y1-y0)*scale)/2;
  draw();
}}
function draw() {{
  const P = DATA.frames[f];
  ctx.clearRect(0,0,cv.width,cv.height);
  ctx.strokeStyle = '#3b6ea5'; ctx.lineWidth = 0.7;
  ctx.beginPath();
  for (const [a,b] of DATA.segs) {{
    ctx.moveTo(P[a][0]*scale+tx, -P[a][1]*scale+ty);
    ctx.lineTo(P[b][0]*scale+tx, -P[b][1]*scale+ty);
  }}
  ctx.stroke();
  ctx.fillStyle = '#222';
  for (let i=0;i<P.length;i++) if (!DATA.fixed[i])
    ctx.fillRect(P[i][0]*scale+tx-1, -P[i][1]*scale+ty-1, 2, 2);
  ctx.fillStyle = '#d62728';
  for (let i=0;i<P.length;i++) if (DATA.fixed[i])
    ctx.fillRect(P[i][0]*scale+tx-3, -P[i][1]*scale+ty-3, 6, 6);
  itEl.textContent = f;
  chiEl.textContent = DATA.chi2s.length ? DATA.chi2s[f].toPrecision(8) : '-';
}}
slider.oninput = () => {{ f = +slider.value; draw(); }};
document.getElementById('play').onclick = function() {{
  if (timer) {{ clearInterval(timer); timer = null;
                this.innerHTML = '&#9654;'; return; }}
  this.innerHTML = '&#10074;&#10074;';
  timer = setInterval(() => {{
    f = (f + 1) % DATA.frames.length; slider.value = f; draw();
    if (f === DATA.frames.length - 1) {{ clearInterval(timer);
      timer = null; document.getElementById('play').innerHTML='&#9654;'; }}
  }}, 250);
}};
cv.onmousedown = e => drag = [e.clientX - tx, e.clientY - ty];
cv.onmousemove = e => {{ if (drag) {{ tx = e.clientX - drag[0];
  ty = e.clientY - drag[1]; draw(); }} }};
cv.onmouseup = () => drag = null;
cv.ondblclick = fit;
cv.onwheel = e => {{ e.preventDefault();
  const fz = Math.exp(-e.deltaY*0.001);
  tx = e.clientX + (tx-e.clientX)*fz; ty = e.clientY + (ty-e.clientY)*fz;
  scale *= fz; draw(); }};
addEventListener('resize', fit);
fit();
</script></body></html>
"""


def render_replay_html(graph, path, frames, chi2_per_frame=None, *,
                       title="g2o_tpu_torch optimization replay"):
    """Standalone HTML REPLAY of an optimization: ``frames`` is a list of
    ``estimates_by_vid`` snapshots (one per iteration, e.g. recorded by a
    post-iteration action); the page gets a slider + play button stepping
    the graph through them — the no-GUI analogue of the reference
    viewer's step-and-redraw loop (``g2o/apps/g2o_viewer``,
    ``g2o_qglviewer.cpp`` draw on ``optimize()`` steps)."""
    if not frames:
        raise ValueError("render_replay_html: no frames recorded")
    P0, segs, _, fixed, vids = _collect(graph, frames[0])
    Ps = [np.round(P0[:, :2], 5).tolist()]
    for est in frames[1:]:
        P, _, _, _, _ = _collect(graph, est)
        Ps.append(np.round(P[:, :2], 5).tolist())
    data = {
        "frames": Ps,
        "segs": segs.tolist(),
        "fixed": fixed.astype(int).tolist(),
        "chi2s": ([round(float(c), 4) for c in chi2_per_frame]
                  if chi2_per_frame is not None else []),
    }
    html = _REPLAY_TEMPLATE.format(
        title=title, nv=len(P0), ne=len(segs), nf_1=len(Ps) - 1,
        data=json.dumps(data, separators=(",", ":")))
    with open(path, "w") as fh:
        fh.write(html)
    return path


def render_html(graph, path, estimates_by_vid=None, *,
                chi2_by_edge=None, title="g2o_tpu_torch graph"):
    """Standalone interactive HTML rendering (pan/zoom canvas, fixed
    vertices highlighted, optional chi2 edge coloring).  3D graphs are
    projected onto x-y."""
    P, segs, vals, fixed, _ = _collect(graph, estimates_by_vid,
                                       chi2_by_edge)
    data = {
        "P": np.round(P[:, :2], 6).tolist(),
        "segs": segs.tolist(),
        "vals": (np.round(vals, 6).tolist()
                 if chi2_by_edge is not None else []),
        "fixed": fixed.astype(int).tolist(),
    }
    html = _HTML_TEMPLATE.format(
        title=title, nv=len(P), ne=len(segs),
        data=json.dumps(data, separators=(",", ":")))
    with open(path, "w") as fh:
        fh.write(html)
    return path
