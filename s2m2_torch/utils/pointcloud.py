"""Disparity -> depth -> point cloud (reference: model_utils.py:111-136 and
demo/visualize_3d_*.py), a copy of s2m2_tpu/utils/pointcloud.py. open3d-free:
pure numpy with optional PLY export; the open3d viewer is used only when the
package is available.
"""
from __future__ import annotations

import numpy as np


def disparity_to_depth(disp, fx, baseline, doffs=0.0, invalid_value=1e9):
    """depth = baseline * fx / (disp + doffs); non-positive disparity ->
    invalid (reference: model_utils.py:124-125)."""
    disp = np.asarray(disp, np.float64)
    depth = baseline * fx / (disp + doffs)
    depth = np.where(disp <= 0, invalid_value, depth)
    return depth.astype(np.float32)


def get_pointcloud(rgb, disp, calib, depth_trunc=None, stride=1,
                   intrinsic_scale=0.5):
    """Backproject to a colored point cloud.

    calib: dict with 'cam0' (3x3 K), 'baseline', 'doffs' (Middlebury
    convention). intrinsic_scale mirrors the reference's half-intrinsics
    (reference: model_utils.py:117-120). Returns (points (N,3), colors (N,3)).
    """
    if depth_trunc is None:
        depth_trunc = 1e9
    K = np.asarray(calib["cam0"])
    fx = K[0, 0] * intrinsic_scale
    cx = K[0, 2] * intrinsic_scale
    cy = K[1, 2] * intrinsic_scale
    depth = disparity_to_depth(disp, fx, calib["baseline"], calib["doffs"])
    # the reference feeds open3d with depth_scale=1000 (mm -> m)
    depth = depth / 1000.0

    h, w = depth.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    z = depth[::stride, ::stride]
    mask = (z > 0) & (z < depth_trunc)
    x = (xs - cx) * z / fx
    y = (ys - cy) * z / fx
    pts = np.stack([x[mask], y[mask], z[mask]], axis=-1)
    cols = np.asarray(rgb)[::stride, ::stride][mask] / 255.0
    return pts.astype(np.float32), cols.astype(np.float32)


def save_ply(path, points, colors=None):
    """Write an ASCII PLY file (viewer-agnostic export)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            rgb8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for p, c in zip(points, rgb8):
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")


def show_pointcloud(points, colors=None):
    """Interactive viewer if open3d is installed; otherwise no-op with hint."""
    try:
        import open3d as o3d
    except ImportError:
        print("open3d not available — use save_ply()/save_html_viewer() "
              "and an external viewer/browser")
        return
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(points)
    if colors is not None:
        pc.colors = o3d.utility.Vector3dVector(colors)
    o3d.visualization.draw_geometries([pc])


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>s2m2 point cloud</title>
<style>html,body{margin:0;height:100%;overflow:hidden;background:#111}
canvas{width:100%;height:100%;display:block}
#hud{position:fixed;left:8px;top:8px;color:#9a9a9a;
font:12px system-ui;user-select:none}</style></head>
<body><canvas id="c"></canvas>
<div id="hud">__NPTS__ points &mdash; drag: orbit &middot; wheel: zoom
&middot; shift-drag: pan</div>
<script>
"use strict";
const PTS = Uint8Array.from(atob("__PTS_B64__"), c => c.charCodeAt(0));
const COL = Uint8Array.from(atob("__COL_B64__"), c => c.charCodeAt(0));
const pos = new Float32Array(PTS.buffer);
const n = pos.length / 3;
// bounding box -> center + scale
let mn = [1e30, 1e30, 1e30], mx = [-1e30, -1e30, -1e30];
for (let i = 0; i < n; i++) for (let a = 0; a < 3; a++) {
  const v = pos[3 * i + a];
  if (v < mn[a]) mn[a] = v; if (v > mx[a]) mx[a] = v;
}
const ctr = [0, 1, 2].map(a => (mn[a] + mx[a]) / 2);
const rad = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2]) / 2 || 1;
const cv = document.getElementById("c");
const gl = cv.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
varying vec3 vc; void main(){ gl_Position = mvp * vec4(p, 1.0);
gl_PointSize = 2.0; vc = col; }`;
const fs = `precision mediump float; varying vec3 vc;
void main(){ gl_FragColor = vec4(vc, 1.0); }`;
function sh(type, src){ const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
function buf(data, loc, size, type, norm){
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc, size, type, norm, 0, 0); }
buf(pos, gl.getAttribLocation(prog, "p"), 3, gl.FLOAT, false);
buf(COL, gl.getAttribLocation(prog, "col"), 3, gl.UNSIGNED_BYTE, true);
const uMVP = gl.getUniformLocation(prog, "mvp");
let yaw = 0.5, pitch = -0.4, dist = 2.5 * rad, panX = 0, panY = 0;
function mat(){
  // view: v = R * (p - ctr) + (panX, panY, -dist); then perspective.
  const a = cv.clientWidth / Math.max(1, cv.clientHeight);
  const f = 1.5, near = rad / 100, far = rad * 100;
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const R = [cy, 0, -sy,  sy*sp, cp, cy*sp,  sy*cp, -sp, cy*cp]; // row-major
  const t = [0, 1, 2].map(r =>
    -(R[3*r]*ctr[0] + R[3*r+1]*ctr[1] + R[3*r+2]*ctr[2]));
  const zz = (far + near) / (near - far), zw = 2 * far * near / (near - far);
  const tx = t[0] + panX, ty = t[1] + panY, tz = t[2] - dist;
  // column-major mat4 of P * V
  return new Float32Array([
    f/a*R[0], f*R[3], zz*R[6], -R[6],
    f/a*R[1], f*R[4], zz*R[7], -R[7],
    f/a*R[2], f*R[5], zz*R[8], -R[8],
    f/a*tx,   f*ty,   zz*tz + zw, -tz
  ]);
}
function draw(){
  const w = cv.clientWidth, h = cv.clientHeight;
  if (cv.width !== w || cv.height !== h){ cv.width = w; cv.height = h; }
  gl.viewport(0, 0, w, h); gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.066, 0.066, 0.066, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uMVP, false, mat());
  gl.drawArrays(gl.POINTS, 0, n);
  requestAnimationFrame(draw);
}
let drag = null;
cv.addEventListener("mousedown", e => drag = [e.clientX, e.clientY, e.shiftKey]);
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { panX += dx * rad / 300; panY -= dy * rad / 300; }
  else { yaw += dx * 0.008; pitch += dy * 0.008; }
  drag = [e.clientX, e.clientY, drag[2]];
});
cv.addEventListener("wheel", e => {
  dist *= Math.exp(e.deltaY * 0.001); e.preventDefault();
}, {passive: false});
draw();
</script></body></html>
"""


def save_html_viewer(path, points, colors=None, max_points=400_000):
    """Write a fully self-contained interactive WebGL viewer (single HTML
    file, zero dependencies/CDN) for the cloud — the headless-environment
    answer to the reference's open3d windows (reference:
    vis_utils.py:83-115): open the file in any browser, orbit/zoom/pan.

    Point/color data is embedded base64; clouds larger than max_points are
    uniformly subsampled to keep the file size sane (~15 bytes/point)."""
    import base64

    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None:
        cols = np.full((len(pts), 3), 200, np.uint8)
    else:
        cols = np.clip(np.asarray(colors, np.float32).reshape(-1, 3) * 255,
                       0, 255).astype(np.uint8)
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts, cols = pts[idx], cols[idx]
    html = (_HTML_TEMPLATE
            .replace("__NPTS__", str(len(pts)))
            .replace("__PTS_B64__",
                     base64.b64encode(pts.tobytes()).decode("ascii"))
            .replace("__COL_B64__",
                     base64.b64encode(cols.tobytes()).decode("ascii")))
    with open(path, "w") as f:
        f.write(html)
    return path
