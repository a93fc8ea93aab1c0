"""Visualization: the self-contained 3d.html scene viewer, PLY export,
plotly 3D scene dumps and matplotlib 2D plots (host copy of
mpsfm_tpu/utils/viz.py).

The reference's viz subsystem (mpsfm/utils/viz_3d.py,
sfm/scene/reconstruction/mixins/visualization.py): camera frusta, sparse
points and depth-map point clouds. `write_scene_html` (the pipeline's
3d.html at verbose >= 1) and `write_ply` need numpy only and write the JAX
package's bytes for the same reconstruction; plotly and matplotlib load
lazily, so a headless pipeline never pays for them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def init_figure(height: int = 800):
    import plotly.graph_objects as go

    fig = go.Figure()
    axes = dict(visible=False, showbackground=False, showgrid=False,
                showline=False, showticklabels=True, autorange=True)
    fig.update_layout(
        template="plotly_dark", height=height,
        scene_camera=dict(eye=dict(x=0.0, y=-0.1, z=-2), up=dict(x=0, y=-1.0, z=0),
                          projection=dict(type="orthographic")),
        scene=dict(xaxis=axes, yaxis=axes, zaxis=axes, aspectmode="data", dragmode="orbit"),
        margin=dict(l=0, r=0, b=0, t=0, pad=0),
        legend=dict(orientation="h", yanchor="top", y=0.99, xanchor="left", x=0.1),
    )
    return fig


def plot_points(fig, pts, color="rgba(255,0,0,1)", ps=2, name=None):
    import plotly.graph_objects as go

    fig.add_trace(
        go.Scatter3d(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers", name=name,
            legendgroup=name, marker=dict(size=ps, color=color, line_width=0),
        )
    )
    return fig


def plot_camera(fig, R, t, K, color="rgb(0,200,250)", name=None, size=1.0):
    """Camera frustum wireframe. R,t = cam_from_world; K = 3x3."""
    import plotly.graph_objects as go

    W = K[0, 2] * 2
    H = K[1, 2] * 2
    corners = np.array([[0, 0], [W, 0], [W, H], [0, H], [0, 0]])
    scale = size / K[0, 0]
    corners_cam = np.concatenate(
        [(corners - K[:2, 2]) * scale, np.full((5, 1), size)], axis=1
    )
    center = -R.T @ t
    corners_w = (R.T @ corners_cam.T).T + center
    x, y, z = [], [], []
    for c in corners_w:
        x += [center[0], c[0], None]
        y += [center[1], c[1], None]
        z += [center[2], c[2], None]
    x += corners_w[:, 0].tolist()
    y += corners_w[:, 1].tolist()
    z += corners_w[:, 2].tolist()
    fig.add_trace(
        go.Scatter3d(x=x, y=y, z=z, mode="lines", legendgroup=name, name=name,
                     line=dict(color=color, width=2), showlegend=False)
    )
    return fig


def plot_reconstruction(rec, fig=None, max_points=50000, point_color="rgba(255,255,255,0.8)"):
    """Plot cameras + sparse points of a Reconstruction."""
    if fig is None:
        fig = init_figure()
    pids = rec.point_ids()
    if len(pids) > max_points:
        pids = np.random.default_rng(0).choice(pids, max_points, replace=False)
    if len(pids):
        plot_points(fig, rec.xyz[pids], color=point_color, name="points")
    for imid, im in rec.registered_images.items():
        cam = rec.camera(imid)
        plot_camera(fig, im.pose.rotation_matrix(), im.pose.t, cam.calibration_matrix(),
                    name=im.name, size=0.5)
    return fig


def plot_depth_cloud(rec, imid, fig=None, stride=4, color=None):
    """Unproject an image's (refined) depth map into the world."""
    if fig is None:
        fig = init_figure()
    im = rec.images[imid]
    d = getattr(im, "depth", None)
    if d is None:
        return fig
    depth = d.data if (d.activated and d.data is not None) else d.data_prior
    cam = rec.camera(imid)
    H, W = depth.shape
    xx, yy = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
    dd = depth[yy, xx]
    fx, fy = cam.fx * cam.sx, cam.fy * cam.sy
    cx, cy = cam.cx * cam.sx, cam.cy * cam.sy
    p_cam = np.stack([(xx - cx) / fx * dd, (yy - cy) / fy * dd, dd], -1).reshape(-1, 3)
    valid = d.valid[yy, xx].reshape(-1)
    p_world = im.pose.inverse().transform(p_cam[valid])
    plot_points(fig, p_world, color=color or "rgba(100,180,255,0.5)", ps=1, name=f"depth:{im.name}")
    return fig


_VIEWER_TEMPLATE = """<!DOCTYPE html><html><head><meta charset="utf-8">
<style>body{margin:0;background:#111;color:#ccc;font-family:monospace}
canvas{display:block}#info{position:fixed;top:8px;left:8px}</style></head>
<body><div id="info">__TITLE__ — drag to orbit, wheel to zoom</div>
<canvas id="c"></canvas><script>
const D=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let rx=-0.4,ry=0.6,zoom=1.0,cx0=0,cy0=0,drag=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
function proj(p){
 const c1=Math.cos(ry),s1=Math.sin(ry),c2=Math.cos(rx),s2=Math.sin(rx);
 let x=p[0]*c1+p[2]*s1, z=-p[0]*s1+p[2]*c1;
 let y=p[1]*c2-z*s2; z=p[1]*s2+z*c2;
 const f=zoom*Math.min(cv.width,cv.height)/(D.extent*2.5);
 return [cv.width/2+x*f, cv.height/2+y*f, z];}
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 ctx.fillStyle='rgba(255,255,255,0.75)';
 for(const p of D.points){const q=proj(p);ctx.fillRect(q[0],q[1],1.6,1.6);}
 ctx.strokeStyle='#0cf';ctx.lineWidth=1.2;
 for(const cam of D.cameras){const c=proj(cam.c);
  for(const k of cam.f){const q=proj(k);
   ctx.beginPath();ctx.moveTo(c[0],c[1]);ctx.lineTo(q[0],q[1]);ctx.stroke();}
  ctx.beginPath();let first=null;
  for(const k of cam.f){const q=proj(k);if(first===null){ctx.moveTo(q[0],q[1]);first=q;}else ctx.lineTo(q[0],q[1]);}
  if(first)ctx.lineTo(first[0],first[1]);ctx.stroke();}}
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(drag){ry+=(e.clientX-drag[0])*0.01;rx+=(e.clientY-drag[1])*0.01;drag=[e.clientX,e.clientY];draw();}};
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);draw();e.preventDefault();};
window.onresize=resize;resize();
</script></body></html>"""


def write_scene_html(rec, path, max_points=20000, title="mpsfm_tpu reconstruction"):
    """The mapper's 3d.html dump (reference mapper/base.py:829-839) as a
    self-contained zero-dependency orbit viewer (plotly isn't in-image)."""
    import json

    pids = rec.point_ids()
    if len(pids) > max_points:
        pids = np.random.default_rng(0).choice(pids, max_points, replace=False)
    pts = rec.xyz[pids] if len(pids) else np.zeros((0, 3))
    cams = []
    centers = []
    for imid, im in rec.registered_images.items():
        cam = rec.camera(imid)
        K = cam.calibration_matrix()
        R = im.pose.rotation_matrix()
        c = im.pose.center()
        centers.append(c)
        W = K[0, 2] * 2 or 100
        H = K[1, 2] * 2 or 100
        size = 0.4
        scale = size / max(K[0, 0], 1e-6)
        corners = np.array([[0, 0], [W, 0], [W, H], [0, H]])
        corners_cam = np.concatenate([(corners - K[:2, 2]) * scale, np.full((4, 1), size)], 1)
        corners_w = (R.T @ corners_cam.T).T + c
        cams.append({"c": c.tolist(), "f": corners_w.tolist()})
    all_pts = np.concatenate([pts] + ([np.stack(centers)] if centers else []))
    if len(all_pts):
        center = all_pts.mean(0)
        extent = float(np.abs(all_pts - center).max()) or 1.0
        pts = pts - center
        cams = [
            {"c": (np.asarray(cc["c"]) - center).tolist(), "f": (np.asarray(cc["f"]) - center).tolist()}
            for cc in cams
        ]
    else:
        extent = 1.0
    data = {"points": np.round(pts, 4).tolist(), "cameras": cams, "extent": extent}
    html = _VIEWER_TEMPLATE.replace("__DATA__", json.dumps(data)).replace("__TITLE__", title)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(html)
    return path


def write_ply(rec, path, max_points=200000):
    """Sparse point cloud as PLY (MeshLab/CloudCompare-compatible)."""
    pids = rec.point_ids()
    if len(pids) > max_points:
        pids = np.random.default_rng(0).choice(pids, max_points, replace=False)
    pts = rec.xyz[pids]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\nend_header\n")
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
    return path


def plot_depth_maps(rec, imid, save=None):
    """2D prior vs refined depth + uncertainty panel (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im = rec.images[imid]
    d = im.depth
    fig, axs = plt.subplots(1, 3, figsize=(15, 4))
    axs[0].imshow(d.data_prior)
    axs[0].set_title("prior depth")
    if d.activated and d.data is not None:
        axs[1].imshow(d.data)
        axs[1].set_title("refined depth")
    axs[2].imshow(np.log10(np.clip(d.uncertainty, 1e-8, None)))
    axs[2].set_title("log10 uncertainty")
    for ax in axs:
        ax.axis("off")
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=100)
        plt.close(fig)
    return fig
