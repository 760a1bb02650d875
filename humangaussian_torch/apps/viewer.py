"""Browser live viewer and pose editor for trained avatars.

Port of humangaussian_tpu/apps/viewer.py: a stdlib HTTP server (a
`ThreadingHTTPServer` thread) serves an orbit-controls page and renders
frames on demand from the scene's device, so a browser pointed at the
host inspects the avatar live:

- `/` the page, `/render?azimuth=&elevation=&distance=&mode=` a PNG
  frame, `/info` the Gaussian count, `/pose` and `/joints` the pose
  editor's state and the projected body joints;
- `POST /pose` sets per-joint axis-angle values of the 21 SMPL-X body
  joints and the global orient; `POST /drag` turns a screen-space drag of
  a joint into a rotation of its parent bone (conjugated into the parent's
  frame with `smplx.lbs.joint_world_rotations`);
- modes: "gs" the Gaussian splats through the tiled rasterizer (one K1
  launch a frame on the card), "mesh" the normal-shaded posed SMPL-X mesh
  (`nerf.explicit.rasterize_mesh`), "skel" the projected skeleton.

With `--smplx_path` (or an `animator=`) the avatar is re-posed through
the one-time Gaussian-to-mesh LBS binding (animation.AvatarAnimator).

Differences from the JAX module: the handlers render on the server's
threads, so `render` enters `torch.no_grad()` itself (grad mode is
thread-local), holds the server's lock for the whole frame (renders are
serialized; the pose state is read under the same, re-entrant, lock) and
copies the frame to the host (which waits for the device) before the PNG
encode. `main` takes `--device` (default cuda; raises without a card).

Usage:
    python -m humangaussian_torch.apps.viewer --ply last.ply [--port 8600]
        [--smplx_path SMPLX_NEUTRAL.npz] [--device cpu]
or programmatically: ViewerServer(scene).start() beside a train loop
(call `server.update_scene(state.scene)` between steps).
"""
from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

# SMPL-X body joints 1..21 (the 21 body_pose rows), reference order
BODY_JOINTS = (
    "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
)

_PAGE = """<!doctype html><html><head><title>humangaussian viewer</title>
<style>body{background:#111;color:#eee;font-family:monospace;text-align:center}
img{image-rendering:auto;border:1px solid #444}
#pose{margin:8px auto;max-width:560px;display:none}
input[type=range]{width:110px}</style></head><body>
<h3>humangaussian live viewer</h3>
<div>azimuth <span id="az">0</span>&deg; elevation <span id="el">15</span>&deg;
 distance <span id="d">2.0</span> &mdash; arrows orbit, +/- zoom, r spins
 &mdash; view <select id="mode"><option value="gs">gaussians</option>
 <option value="mesh">mesh</option><option value="skel">skeleton</option>
 </select></div>
<div style="position:relative;display:inline-block">
<img id="view" width="512" height="512"/>
<canvas id="ov" width="512" height="512"
 style="position:absolute;left:0;top:0"></canvas></div>
<div id="pose">
 <select id="joint"></select>
 x <input type="range" id="rx" min="-1.6" max="1.6" step="0.05" value="0">
 y <input type="range" id="ry" min="-1.6" max="1.6" step="0.05" value="0">
 z <input type="range" id="rz" min="-1.6" max="1.6" step="0.05" value="0">
 <button id="reset">reset pose</button>
</div>
<script>
let az=0, el=15, d=2.0, spin=false, pose=null, joints=null, drag=null;
const cam=()=>`azimuth=${az}&elevation=${el}&distance=${d}`;
function refresh(){
  document.getElementById('az').textContent=az.toFixed(0);
  document.getElementById('el').textContent=el.toFixed(0);
  document.getElementById('d').textContent=d.toFixed(2);
  const m=document.getElementById('mode').value;
  document.getElementById('view').src=
    `/render?${cam()}&mode=${m}&t=${Date.now()}`;
  if(pose&&pose.posable)fetch(`/joints?${cam()}`).then(r=>r.json())
    .then(j=>{joints=j;drawJoints();});
}
function drawJoints(){
  const cv=document.getElementById('ov'),ctx=cv.getContext('2d');
  ctx.clearRect(0,0,cv.width,cv.height);
  if(!joints||!joints.posable)return;
  ctx.fillStyle='rgba(255,220,40,.85)';
  joints.xy.forEach(([x,y],i)=>{if(i>0){
    ctx.beginPath();ctx.arc(x,y,4,0,7);ctx.fill();}});
}
const ov=document.getElementById('ov');
ov.addEventListener('mousedown',e=>{
  if(!joints)return;
  const r=ov.getBoundingClientRect(),x=e.offsetX,y=e.offsetY;
  let best=-1,bd=144;
  joints.xy.forEach(([jx,jy],i)=>{const q=(jx-x)**2+(jy-y)**2;
    if(i>0&&q<bd){bd=q;best=i;}});
  if(best>0)drag={joint:best,from:[x,y]};});
ov.addEventListener('mouseup',e=>{
  if(!drag)return;
  const body={joint:drag.joint,from:drag.from,to:[e.offsetX,e.offsetY],
    azimuth:az,elevation:el,distance:d};
  fetch('/drag',{method:'POST',body:JSON.stringify(body)})
    .then(r=>r.json()).then(p2=>{pose=p2;refresh();});
  drag=null;});
document.getElementById('mode').onchange=refresh;
document.addEventListener('keydown',e=>{
  if(e.key=='ArrowLeft')az-=10; if(e.key=='ArrowRight')az+=10;
  if(e.key=='ArrowUp')el=Math.min(el+5,89); if(e.key=='ArrowDown')el=Math.max(el-5,-89);
  if(e.key=='+')d=Math.max(d-0.1,0.3); if(e.key=='-')d+=0.1;
  if(e.key=='r')spin=!spin; refresh();});
setInterval(()=>{if(spin){az=(az+10)%360; refresh();}},250);
fetch('/pose').then(r=>r.ok?r.json():null).then(p=>{
  if(!p||!p.posable)return; pose=p;
  const sel=document.getElementById('joint');
  p.joints.forEach((n,i)=>{const o=document.createElement('option');
    o.value=i;o.textContent=n;sel.appendChild(o);});
  document.getElementById('pose').style.display='block';
  function load(){const j=+sel.value, v=pose.body_pose[j];
    ['rx','ry','rz'].forEach((id,a)=>
      document.getElementById(id).value=v[a]);}
  sel.onchange=load; load();
  function push(){
    const j=+sel.value;
    const v=['rx','ry','rz'].map(id=>+document.getElementById(id).value);
    pose.body_pose[j]=v;
    fetch('/pose',{method:'POST',body:JSON.stringify({joint:j,values:v})})
      .then(()=>refresh());}
  ['rx','ry','rz'].forEach(id=>
    document.getElementById(id).oninput=push);
  document.getElementById('reset').onclick=()=>{
    fetch('/pose',{method:'POST',body:JSON.stringify({reset:true})})
      .then(r=>r.json()).then(p2=>{pose=p2;load();refresh();});};
});
refresh();
</script></body></html>"""


def _rodrigues_np(aa: np.ndarray) -> np.ndarray:
    """axis-angle [3] -> rotation matrix [3,3] (numpy)."""
    th = float(np.linalg.norm(aa))
    if th < 1e-8:
        return np.eye(3, dtype=np.float32)
    k = aa / th
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float32
    )
    return np.eye(3, dtype=np.float32) + np.sin(th) * kx + (
        1.0 - np.cos(th)
    ) * (kx @ kx)


def _log_map(r: np.ndarray) -> np.ndarray:
    """rotation matrix [3,3] -> axis-angle [3] (numpy)."""
    c = float(np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0))
    th = float(np.arccos(c))
    if th < 1e-6:
        return np.zeros(3, np.float32)
    ax = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]], np.float32
    ) / (2.0 * np.sin(th))
    return (ax * th).astype(np.float32)




class ViewerServer:
    """Serves / (controls page), /render (PNG frame), /info, /pose,
    /joints and POST /pose, /drag for `scene` (a GaussianScene on its
    device), re-posed through `animator` when one is given."""

    def __init__(self, scene, port: int = 8600, size: int = 512,
                 sh_degree: int = 0, animator=None):
        self.port = port
        self.size = size
        self.sh_degree = sh_degree
        self._scene = scene
        self._lock = threading.RLock()
        self._httpd = None
        # pose editing: per-joint axis-angle state mutated by POST /pose,
        # applied through the animator's LBS binding
        self.animator = animator
        self._body_pose = np.zeros((21, 3), np.float32)
        self._global_orient = np.zeros(3, np.float32)

    @property
    def device(self) -> torch.device:
        return self._scene.device

    # ---- pose editing ---------------------------------------------------
    def pose_state(self) -> dict:
        with self._lock:
            return {
                "posable": self.animator is not None,
                "joints": list(BODY_JOINTS),
                "body_pose": self._body_pose.tolist(),
                "global_orient": self._global_orient.tolist(),
            }

    def set_pose(self, update: dict) -> dict:
        """Apply a POST /pose update: {"joint": i, "values": [x,y,z]} for
        one joint, {"body_pose": [[...]x21]} / {"global_orient": [...]} in
        bulk, or {"reset": true}."""
        with self._lock:
            if update.get("reset"):
                self._body_pose[:] = 0.0
                self._global_orient[:] = 0.0
            if "joint" in update:
                j = int(update["joint"])
                if not 0 <= j < 21:
                    raise ValueError(f"joint index {j} out of range [0,21)")
                self._body_pose[j] = np.asarray(
                    update["values"], np.float32).reshape(3)
            if "body_pose" in update:
                self._body_pose[:] = np.asarray(
                    update["body_pose"], np.float32).reshape(21, 3)
            if "global_orient" in update:
                self._global_orient[:] = np.asarray(
                    update["global_orient"], np.float32).reshape(3)
        return self.pose_state()

    def update_scene(self, scene):
        with self._lock:
            self._scene = scene

    # ---- skeleton geometry (drag editing + skel display mode) ----------
    def _current_pose(self):
        from humangaussian_torch.smplx.lbs import SMPLXPose

        with self._lock:
            bp = torch.from_numpy(self._body_pose.copy())
            go = torch.from_numpy(self._global_orient.copy())
        dev = self.device
        return SMPLXPose.rest(body_pose=bp.to(dev))._replace(
            global_orient=go.to(dev))

    def _normalize(self, pts: torch.Tensor) -> np.ndarray:
        """Body-model points -> the avatar's scene space (the animator's
        frozen normalization), as a host array."""
        a = self.animator
        return ((pts.cpu().numpy() - a.ori_center) * a.ori_scale
                * a.scale_factor).astype(np.float32)

    def _posed_joints(self):
        """Scene-space positions of the 22 kinematic body joints (pelvis +
        BODY_JOINTS) and the pose they were taken at."""
        from humangaussian_torch.smplx.lbs import lbs_forward

        pose = self._current_pose()
        _, joints = lbs_forward(self.animator.model, pose)
        return self._normalize(joints[:22]), pose

    def _camera(self, azimuth, elevation, distance):
        from humangaussian_torch.core.camera import camera_from_c2w
        from humangaussian_torch.data.cameras import c2w_from_angles

        f32 = dict(dtype=torch.float32, device=self.device)
        c2w = c2w_from_angles(torch.tensor([elevation], **f32),
                              torch.tensor([azimuth], **f32),
                              torch.tensor([distance], **f32))[0]
        return camera_from_c2w(c2w, 0.8, self.size, self.size), c2w

    def _project(self, pts, cam):
        """[N,3] scene space -> [N,2] pixel coords (ndc2Pix)."""
        hom = np.concatenate([pts, np.ones((pts.shape[0], 1), np.float32)], 1)
        clip = hom @ cam.full_proj.cpu().numpy()
        w = clip[:, 3:4]
        ndc = clip[:, :2] / np.where(np.abs(w) > 1e-8, w, 1e-8)
        x = ((ndc[:, 0] + 1.0) * self.size - 1.0) * 0.5
        y = ((ndc[:, 1] + 1.0) * self.size - 1.0) * 0.5
        return np.stack([x, y], 1)

    def joints_2d(self, azimuth, elevation, distance) -> dict:
        """GET /joints: projected 2D body-joint pixel positions and the
        kinematic parent of each (for the drag overlay)."""
        if self.animator is None:
            return {"posable": False}
        with self._lock, torch.no_grad():
            pts, _ = self._posed_joints()
            cam, _ = self._camera(azimuth, elevation, distance)
            xy = self._project(pts, cam)
        parents = np.asarray(self.animator.model.parents)[:22]
        return {
            "posable": True,
            "xy": xy.round(1).tolist(),
            "parents": parents.tolist(),
            "names": ["pelvis"] + list(BODY_JOINTS),
        }

    def apply_drag(self, update: dict) -> dict:
        """POST /drag {joint, from:[x,y], to:[x,y], azimuth, elevation,
        distance}: rotate the dragged joint's PARENT bone so that the joint
        follows the cursor; the screen-space drag becomes a rotation about
        the camera's view axis through the parent joint, conjugated into
        the parent's kinematic frame."""
        from humangaussian_torch.smplx.lbs import joint_world_rotations

        jd = int(update["joint"])
        if not 1 <= jd < 22:
            raise ValueError("drag a body joint (1..21), not the pelvis")
        with self._lock, torch.no_grad():
            pts, pose = self._posed_joints()
            cam, c2w = self._camera(
                float(update.get("azimuth", 0.0)),
                float(update.get("elevation", 15.0)),
                float(update.get("distance", 2.0)),
            )
            parents = np.asarray(self.animator.model.parents)
            p = int(parents[jd])
            xy = self._project(pts, cam)
            pivot = xy[p]
            v0 = np.asarray(update["from"], np.float32) - pivot
            v1 = np.asarray(update["to"], np.float32) - pivot
            n0, n1 = np.linalg.norm(v0), np.linalg.norm(v1)
            min_r = max(2.0, self.size * 0.01)
            if n0 < min_r or n1 < min_r:
                return self.pose_state()  # degenerate drag at the pivot
            v0, v1 = v0 / n0, v1 / n1
            # screen y grows DOWN: the visible CCW angle flips sign
            theta = -np.arctan2(v0[0] * v1[1] - v0[1] * v1[0],
                                float(v0 @ v1))
            # camera forward (world, OpenGL c2w: -z column)
            fwd = -c2w[:3, 2].cpu().numpy()
            fwd /= np.linalg.norm(fwd)
            world = joint_world_rotations(self.animator.model,
                                          pose).cpu().numpy()
            r_gp = world[parents[p]] if p > 0 else np.eye(3, dtype=np.float32)
            d_local = _rodrigues_np(r_gp.T @ fwd * theta)
            if p == 0:
                r_old = _rodrigues_np(self._global_orient)
                self._global_orient[:] = _log_map(d_local @ r_old)
            else:
                r_old = _rodrigues_np(self._body_pose[p - 1])
                self._body_pose[p - 1] = _log_map(d_local @ r_old)
        return self.pose_state()

    # ---- rendering ----------------------------------------------------
    def render(self, azimuth: float, elevation: float, distance: float,
               mode: str = "gs") -> np.ndarray:
        """One [size, size, 3] float32 frame on the host. `mode` is "gs"
        (the Gaussian splats), "mesh" (the normal-shaded posed SMPL-X
        mesh) or "skel" (the projected kinematic skeleton); the last two
        need an animator and fall back to "gs" without one."""
        with self._lock, torch.no_grad():
            cam, _ = self._camera(azimuth, elevation, distance)
            if mode == "mesh" and self.animator is not None:
                return self._render_mesh(cam)
            if mode == "skel" and self.animator is not None:
                return self._render_skeleton(cam)
            return self._render_splats(cam)

    def _render_splats(self, cam) -> np.ndarray:
        from humangaussian_torch.ops.rasterize_tiled import rasterize_tiled

        scene = self._scene
        if self.animator is not None:
            scene = self.animator.frame_scene(self._current_pose())
        out = rasterize_tiled(
            scene.means, scene.scales, scene.quats, scene.features,
            scene.opacities, scene.alive, cam,
            torch.zeros(3, dtype=torch.float32, device=self.device),
            self.sh_degree,
        )
        return out["image"].cpu().numpy()

    def _render_mesh(self, cam) -> np.ndarray:
        from humangaussian_torch.nerf.explicit import (
            face_normals,
            rasterize_mesh,
        )
        from humangaussian_torch.smplx.lbs import lbs_forward

        model = self.animator.model
        verts, _ = lbs_forward(model, self._current_pose())
        tri = torch.from_numpy(self._normalize(verts)).to(
            self.device)[model.faces]  # [F,3,3]
        attrs = face_normals(tri)[:, None, :].expand(tri.shape)
        out = rasterize_mesh(
            tri, torch.ones(tri.shape[0], dtype=torch.bool,
                            device=self.device),
            cam.full_proj, self.size, self.size, attrs=attrs)
        img = out["attr"] * 0.5 + 0.5
        return torch.where(out["mask"][..., None], img, 0.0).cpu().numpy()

    def _render_skeleton(self, cam) -> np.ndarray:
        from PIL import Image, ImageDraw

        pts, _ = self._posed_joints()
        xy = self._project(pts, cam)
        parents = np.asarray(self.animator.model.parents)[:22]
        im = Image.new("RGB", (self.size, self.size))
        drw = ImageDraw.Draw(im)
        for j in range(1, 22):
            drw.line([tuple(xy[int(parents[j])]), tuple(xy[j])],
                     fill=(40, 160, 240), width=max(2, self.size // 170))
        r = max(3, self.size // 128)
        for x, y in xy:
            drw.ellipse([x - r, y - r, x + r, y + r], fill=(250, 90, 60))
        return np.asarray(im, np.float32) / 255.0

    def png(self, img: np.ndarray) -> bytes:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(
            (np.clip(img, 0, 1) * 255).astype(np.uint8)).save(buf, "PNG")
        return buf.getvalue()

    # ---- http ---------------------------------------------------------
    def start(self, background: bool = True):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj):
                self._send(200, "application/json", json.dumps(obj).encode())

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)

                def f(name, default):
                    return float(q.get(name, [default])[0])

                view = (f("azimuth", 0.0), f("elevation", 15.0),
                        f("distance", 2.0))
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/info":
                    with viewer._lock:
                        n = int(viewer._scene.alive.sum())
                    self._json({"n_gaussians": n, "size": viewer.size})
                elif u.path == "/pose":
                    self._json(viewer.pose_state())
                elif u.path == "/joints":
                    self._json(viewer.joints_2d(*view))
                elif u.path == "/render":
                    img = viewer.render(*view, mode=q.get("mode", ["gs"])[0])
                    self._send(200, "image/png", viewer.png(img))
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                u = urlparse(self.path)
                if u.path not in ("/pose", "/drag"):
                    self._send(404, "text/plain", b"not found")
                    return
                if viewer.animator is None:
                    self._send(
                        400, "application/json",
                        b'{"error": "no animator: start the viewer with '
                        b'--smplx_path to enable pose editing"}',
                    )
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    update = json.loads(self.rfile.read(n) or b"{}")
                    state = (viewer.apply_drag(update) if u.path == "/drag"
                             else viewer.set_pose(update))
                except (ValueError, KeyError) as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}).encode())
                    return
                self._json(state)

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]
        if background:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()
        else:
            self._httpd.serve_forever()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ply", required=True)
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument(
        "--smplx_path", default=None,
        help="SMPL-X model npz: enables the pose-editor sliders")
    parser.add_argument("--gender", default="neutral")
    parser.add_argument("--device", default="cuda")
    return parser


def build_server(argv=None) -> ViewerServer:
    """The CLI's server, not started: the PLY on `--device` and, with
    `--smplx_path`, its animator. The animator binds the avatar in the
    animation frame (the PLY loader's `animation_convention`, as
    apps.animate loads it); the JAX CLI loads the training frame there and
    binds only the Gaussians that happen to lie near the turned mesh."""
    from humangaussian_torch import resolve_device
    from humangaussian_torch.io.ply import load_ply

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    scene = load_ply(args.ply, animation_convention=bool(args.smplx_path),
                     device=dev)
    animator = None
    if args.smplx_path:
        from humangaussian_torch.animation import AvatarAnimator
        from humangaussian_torch.convert import smplx_from_numpy
        from humangaussian_torch.smplx.model import load_smplx_npz

        model = smplx_from_numpy(
            load_smplx_npz(args.smplx_path, gender=args.gender), dev)
        animator = AvatarAnimator(scene, model)
        print(f"pose editing on ({animator.n_gaussians} bound gaussians)")
    return ViewerServer(scene, port=args.port, size=args.size,
                        animator=animator)


def main(argv=None):
    server = build_server(argv)
    print(f"viewer at http://localhost:{server.port}/ (ctrl-c to stop)")
    server.start(background=False)


if __name__ == "__main__":
    main()
