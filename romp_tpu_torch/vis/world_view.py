"""World/global-view TRACE visualization, headless (the port's copy of
`romp_tpu/vis/world_view.py`, numpy and scipy only).

Parity targets:
- `trace/lib/visualization/world_vis.py`: camera-pose solving from world
  joints + 2D projections (:52-111), global-view mesh rendering
  (:113-199), the trajectory entry point (:237-291);
- `trace/lib/visualization/trajectory_viewer.py`: the interactive OpenGL
  dome viewer — re-imagined headless: floor-grid global renders via the
  native rasterizer plus a dependency-free exported HTML orbit viewer
  (serving boxes have no GL/display);
- `plotly_volume_viewer.py` / `web_vis.py`: the HTML export below embeds
  the scene JSON in a self-contained canvas viewer (no plotly/network).

All math is numpy; rendering uses vis/renderer.py (C++ rasterizer).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------ camera math --

def rot_pitch_yaw(pitch: float, yaw: float = 0.0) -> np.ndarray:
    """R = Rx(pitch) @ Ry(yaw) (world_vis.py:212-218 convention, radians).
    """
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return rx @ ry


def get_cam_K(image_h: int, image_w: int, fov: float = 50.0) -> np.ndarray:
    """Intrinsics for a given vertical fov (world_vis.py:200-205)."""
    f = max(image_h, image_w) / 2.0 / np.tan(np.radians(fov / 2.0))
    return np.array([[f, 0, image_w / 2.0],
                     [0, f, image_h / 2.0],
                     [0, 0, 1.0]])


def project_points(points: np.ndarray, K: np.ndarray,
                   R: Optional[np.ndarray] = None,
                   t: Optional[np.ndarray] = None) -> np.ndarray:
    """(..., 3) world points -> (..., 2) pixels (+ depth kept by caller)."""
    p = points if R is None else points @ R.T
    if t is not None:
        p = p + t
    z = np.maximum(p[..., 2:3], 1e-6)
    uv = p[..., :2] / z
    return uv * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])


def solve_camera_pose(world_j3ds: np.ndarray, pj2ds: np.ndarray,
                      K: np.ndarray,
                      init_pitch: float = 0.0, init_tx: float = 0.0
                      ) -> Tuple[float, np.ndarray]:
    """Fit the (pitch, height-offset) camera the reference optimizes with
    Adam (world_vis.py:52-111 CameraPoseSolver): find pitch about X and a
    vertical translation ty such that projecting the world joints matches
    the observed 2D joints. Returns (pitch_rad, t (3,)).

    world_j3ds: (N, J, 3); pj2ds: (N, J, 2) pixels (NaN rows ignored).
    """
    from scipy.optimize import least_squares

    pts = world_j3ds.reshape(-1, 3)
    obs = pj2ds.reshape(-1, 2)
    good = np.isfinite(obs).all(-1) & np.isfinite(pts).all(-1)
    pts, obs = pts[good], obs[good]

    def resid(x):
        pitch, ty = x
        R = rot_pitch_yaw(pitch)
        uv = project_points(pts, K, R, np.array([0.0, ty, 0.0]))
        return (uv - obs).reshape(-1)

    sol = least_squares(resid, x0=np.array([init_pitch, init_tx]),
                        method="lm", max_nfev=200)
    pitch, ty = sol.x
    return float(pitch), np.array([0.0, float(ty), 0.0])


# --------------------------------------------------------- global renders --

TRACK_COLORS = np.array([
    [0.85, 0.35, 0.30], [0.30, 0.60, 0.85], [0.35, 0.75, 0.40],
    [0.85, 0.70, 0.25], [0.65, 0.40, 0.80], [0.30, 0.75, 0.75],
    [0.85, 0.45, 0.65], [0.55, 0.55, 0.35]], np.float32)
GRID_LINES_MAX = 50     # top-down grid lines on each side of the origin


def _draw_floor_grid(image: np.ndarray, K: np.ndarray, R: np.ndarray,
                     t: np.ndarray, y: float, half: float = 8.0,
                     step: float = 1.0) -> None:
    import cv2

    n = int(2 * half / step) + 1
    for i in range(n):
        o = -half + i * step
        for p0, p1 in ((np.array([o, y, 1e-3]), np.array([o, y, 2 * half])),
                       (np.array([-half, y, max(o + half, 1e-3) + 1e-3]),
                        np.array([half, y, max(o + half, 1e-3) + 1e-3]))):
            c0 = p0 @ R.T + t
            c1 = p1 @ R.T + t
            if c0[2] < 1e-3 and c1[2] < 1e-3:
                continue
            uv = project_points(np.stack([p0, p1]), K, R, t)
            cv2.line(image, tuple(np.int32(uv[0])), tuple(np.int32(uv[1])),
                     (70, 70, 70), 1, cv2.LINE_AA)


def render_world_frame(renderer, verts_world: np.ndarray, faces: np.ndarray,
                       track_ids: Sequence[int],
                       image_hw: Tuple[int, int] = (720, 1280),
                       pitch: float = 0.18, cam_height: float = 1.4,
                       cam_back: float = 4.0, fov: float = 50.0,
                       floor: bool = True) -> np.ndarray:
    """One global-view frame (world_vis.py:150-199 vis_global_view):
    meshes in WORLD coordinates viewed from an elevated camera behind the
    origin, per-track colors, optional floor grid.

    verts_world: (N, V, 3). Returns uint8 (H, W, 3) RGB.
    """
    h, w = image_hw
    K = get_cam_K(h, w, fov)
    R = rot_pitch_yaw(pitch)
    if len(verts_world):
        ground_y = float(np.max(verts_world[..., 1]))
        center = verts_world.reshape(-1, 3).mean(0)
    else:
        ground_y, center = 0.0, np.zeros(3)
    t = np.array([-center[0], cam_height - ground_y,
                  cam_back - center[2]]) @ R.T

    image = np.full((h, w, 3), 255, np.uint8)
    if floor:
        _draw_floor_grid(image, K, R, t, y=ground_y)
    if not len(verts_world):
        return image
    cam = verts_world @ R.T + t
    uv = project_points(verts_world, K, R, t)
    verts_px = np.concatenate([uv, -cam[..., 2:3]], axis=-1)  # near wins
    colors = TRACK_COLORS[np.asarray(track_ids) % len(TRACK_COLORS)]
    return renderer.render(
        np.ascontiguousarray(verts_px, np.float32), faces, image, colors)


def draw_trajectory_topdown(tracks: Dict[int, np.ndarray],
                            image_size: int = 720,
                            half_extent: Optional[float] = None
                            ) -> np.ndarray:
    """Bird's-eye (x, z) trajectory plot with per-track colors
    (the trajectory_viewer's DrawTrajectory, headless).

    tracks: track_id -> (F, 3) world translations (NaN = missing frame).
    """
    import cv2

    img = np.full((image_size, image_size, 3), 255, np.uint8)
    pts_all = np.concatenate([v for v in tracks.values()], 0) \
        if tracks else np.zeros((0, 3))
    finite = pts_all[np.isfinite(pts_all).all(-1)]
    if half_extent is None:
        half_extent = float(np.abs(finite[:, [0, 2]]).max()) * 1.2 + 1e-6 \
            if len(finite) else 1.0

    def to_px(p):
        x = (p[..., 0] / half_extent * 0.5 + 0.5) * (image_size - 1)
        yv = (0.5 - p[..., 2] / half_extent * 0.5) * (image_size - 1)
        return np.stack([x, yv], -1)

    # grid every metre, or every k metres when that would draw more than
    # 101 lines a direction (the JAX package's copy draws every metre, and
    # so hangs on the far-off cams of untrained weights)
    n = int(half_extent)
    step = max(1, -(-n // GRID_LINES_MAX))
    for g in range(-n // step * step, n + 1, step):
        u = int((g / half_extent * 0.5 + 0.5) * (image_size - 1))
        cv2.line(img, (u, 0), (u, image_size - 1), (230, 230, 230), 1)
        cv2.line(img, (0, u), (image_size - 1, u), (230, 230, 230), 1)
    for tid, traj in tracks.items():
        c = (TRACK_COLORS[tid % len(TRACK_COLORS)] * 255)[::-1]
        color = tuple(int(v) for v in c)
        px = to_px(traj)
        ok = np.isfinite(px).all(-1)
        for i in range(1, len(px)):
            if ok[i - 1] and ok[i]:
                cv2.line(img, tuple(np.int32(px[i - 1])),
                         tuple(np.int32(px[i])), color, 2, cv2.LINE_AA)
        last = np.where(ok)[0]
        if len(last):
            cv2.circle(img, tuple(np.int32(px[last[-1]])), 5, color, -1)
            cv2.putText(img, str(tid), tuple(np.int32(px[last[-1]]) + 8),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                        cv2.LINE_AA)
    return img


# ------------------------------------------------------------ HTML export --

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>romp_tpu trajectories</title>
<style>body{margin:0;background:#111;color:#ddd;font:12px sans-serif}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">drag: orbit &middot; wheel: zoom &middot;
space: play/pause</div><canvas id="c"></canvas>
<script>
const SCENE = %SCENE%;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=0.6, pitch=0.4, dist=10, frame=0, playing=true;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener('resize',resize);resize();
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*.01;
pitch+=(e.clientY-drag[1])*.01;drag=[e.clientX,e.clientY];}};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*.001);};
onkeydown=e=>{if(e.code=='Space'){playing=!playing;e.preventDefault();}};
function proj(p){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  let x=p[0]*cy+p[2]*sy, z=-p[0]*sy+p[2]*cy, y=p[1];
  let y2=y*cp-z*sp, z2=y*sp+z*cp+dist;
  const f=0.9*Math.min(cv.width,cv.height);
  return [cv.width/2+f*x/z2, cv.height/2+f*y2/z2, z2];}
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
  ctx.strokeStyle='#333';
  for(let g=-8;g<=8;g++){
    let a=proj([g,SCENE.floor_y,-8]),b=proj([g,SCENE.floor_y,8]);
    ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
    a=proj([-8,SCENE.floor_y,g]);b=proj([8,SCENE.floor_y,g]);
    ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();}
  for(const tr of SCENE.tracks){
    ctx.strokeStyle=tr.color;ctx.fillStyle=tr.color;ctx.lineWidth=2;
    ctx.beginPath();let started=false;
    for(let i=0;i<=Math.min(frame,tr.xyz.length-1);i++){
      const p=tr.xyz[i];if(p==null){started=false;continue;}
      const q=proj(p);
      if(!started){ctx.moveTo(q[0],q[1]);started=true;}
      else ctx.lineTo(q[0],q[1]);}
    ctx.stroke();
    const last=tr.xyz[Math.min(frame,tr.xyz.length-1)];
    if(last!=null){const q=proj(last);
      ctx.beginPath();ctx.arc(q[0],q[1],5,0,6.28);ctx.fill();
      ctx.fillText('id '+tr.id,q[0]+8,q[1]);}}
  ctx.fillStyle='#ddd';
  ctx.fillText('frame '+frame+' / '+(SCENE.n_frames-1),8,cv.height-8);
  if(playing)frame=(frame+1)%SCENE.n_frames;
  requestAnimationFrame(draw);}
draw();
</script></body></html>
"""


def export_html_viewer(tracks: Dict[int, np.ndarray], path: str) -> str:
    """Self-contained offline orbit viewer of world trajectories (the
    plotly/web viewer analog, zero dependencies). tracks: id -> (F, 3)
    world positions with NaN for missing frames."""
    n_frames = max((len(v) for v in tracks.values()), default=1)
    floor_y = 0.0
    vals = np.concatenate([v for v in tracks.values()], 0) \
        if tracks else np.zeros((0, 3))
    finite = vals[np.isfinite(vals).all(-1)]
    if len(finite):
        floor_y = float(finite[:, 1].max())
    scene = {"n_frames": int(n_frames), "floor_y": floor_y, "tracks": []}
    for tid, traj in tracks.items():
        c = (TRACK_COLORS[tid % len(TRACK_COLORS)] * 255).astype(int)
        xyz = [None if not np.isfinite(p).all() else
               [round(float(p[0]), 4), round(float(p[1]), 4),
                round(float(p[2]), 4)] for p in traj]
        scene["tracks"].append(
            {"id": int(tid), "color": f"rgb({c[0]},{c[1]},{c[2]})",
             "xyz": xyz})
    html = _HTML_TEMPLATE.replace("%SCENE%", json.dumps(scene))
    with open(path, "w") as f:
        f.write(html)
    return path


# ----------------------------------------------------------- entry point --

def visualize_global_trajectory(outputs: Dict[str, np.ndarray],
                                faces: np.ndarray, save_dir: str,
                                renderer=None,
                                image_hw: Tuple[int, int] = (720, 1280)
                                ) -> List[str]:
    """TracePipeline outputs -> per-frame global-view renders + a top-down
    trajectory png + the HTML viewer (world_vis.py:237-291 equivalent).

    outputs: the flattened (N*T) dict from TracePipeline.process_clip
    (track_ids, frame_ids, frame_valid, world_cams, verts).
    Returns the list of written files.
    """
    import os

    import cv2

    from romp_tpu_torch.vis.renderer import setup_renderer

    os.makedirs(save_dir, exist_ok=True)
    renderer = renderer or setup_renderer("sim3dr")
    tids = np.asarray(outputs["track_ids"])
    fids = np.asarray(outputs["frame_ids"])
    valid = np.asarray(outputs["frame_valid"]).astype(bool)
    world = np.asarray(outputs["world_cams"])
    verts = np.asarray(outputs["verts"])
    written = []

    # world-space verts: camera-space mesh shifted by the world translation
    n_frames = int(fids.max()) + 1
    tracks: Dict[int, np.ndarray] = {}
    for tid in np.unique(tids):
        traj = np.full((n_frames, 3), np.nan)
        sel = (tids == tid) & valid
        traj[fids[sel]] = world[sel]
        tracks[int(tid)] = traj

    for f in range(n_frames):
        sel = (fids == f) & valid
        vw = verts[sel] + world[sel][:, None]
        frame = render_world_frame(renderer, vw, faces, tids[sel],
                                   image_hw=image_hw)
        p = osp.join(save_dir, f"world_{f:06d}.png")
        cv2.imwrite(p, frame[..., ::-1])
        written.append(p)

    p = osp.join(save_dir, "trajectory_topdown.png")
    cv2.imwrite(p, draw_trajectory_topdown(tracks))
    written.append(p)
    written.append(export_html_viewer(
        tracks, osp.join(save_dir, "trajectories.html")))
    return written
