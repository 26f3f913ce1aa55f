"""Interactive web viewer for trained scenes; port of
`mtgs_tpu/viewer/server.py`.

Replaces the reference's forked viser viewer (`mtgs/custom_viewer/` in
OpenDriveLab/MTGS, 3.7k LoC over websockets) with a dependency-free HTTP
implementation: an embedded single-page app with mouse orbit + WASD fly
controls polls `/render` for JPEG frames. The MTGS-specific controls are
preserved:

  * **Travel ID dropdown** (+ the `mean`/`null` multicolor fallbacks) —
    the reference's ControlPanel addition (`control_panel.py:193-252`);
  * **time slider** driving rigid-instance pose interpolation
    (`control_panel.py:395-412`);
  * low-res-while-moving / high-res-when-still render states
    (`render_state_machine.py:54-314` — here the client sends a `moving`
    hint and the server picks the resolution ladder rung);
  * **render panel** — keyframed camera-path editor
    (`render_panel.py` in the reference): capture keyframes while
    flying, set seconds/fps/fov, export the nerfstudio-style
    `camera_path` JSON consumed by
    `mtgs_torch.tools.render.render_camera_path`.

The page (`_PAGE`) is the JAX package's, the contract between client and
server. Each frame is `render_view(..., training=False)` on the card,
coloured there, copied back as uint8 and encoded by the port's own JPEG
encoder (`data/image_io.py::encode_jpeg`, quality 85, PIL's bytes).

Run: `ViewerServer(params, aux, cfg, ...).serve(port=7007)` or
`python -m mtgs_torch.viewer.server --run <dir> [--data ROOT] [--port N]`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.data.image_io import encode_jpeg
from mtgs_torch.tools.export import export_ply, export_point_cloud, export_splat
from mtgs_torch.train.trainer import Batch, TrainerConfig, render_view

_PAGE = """<!DOCTYPE html>
<html><head><title>mtgs_torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px;
       border-radius:6px; z-index:2 }
canvas { display:block; margin:0 auto; }
select,input { background:#222; color:#ddd; border:1px solid #555; }
</style></head><body>
<div id="hud">
 travel <select id="travel"></select>
 output <select id="output">
  <option>rgb</option><option>depth</option>
  <option>accumulation</option><option>normal</option>
 </select>
 time <input id="time" type="range" min="0" max="1" step="0.01" value="0" style="width:140px">
 <span id="fps"></span><br>
 frustums <select id="frustums">
  <option>off</option><option>train</option><option>eval</option><option>all</option>
 </select>
 drag: orbit | wheel: dolly | WASD+QE: fly | shift: fast<br>
 <b>path</b>
 <button id="addkf">+ keyframe</button>
 <button id="clearkf">clear</button>
 <span id="kfn">0 kf</span>
 sec <input id="secs" type="number" value="6" min="1" style="width:44px">
 fps <input id="pathfps" type="number" value="30" min="1" style="width:44px">
 fov <input id="fov" type="number" min="10" max="120" style="width:44px">
 <button id="exportkf">export json</button>
 <b>export</b>
 <a href="export?format=ply">ply</a>
 <a href="export?format=splat">splat</a>
 <a href="export?format=pcd">pcd</a>
</div>
<canvas id="cv"></canvas>
<script>
const cv = document.getElementById('cv'), ctx2 = cv.getContext('2d');
let W = 960, H = 540; cv.width = W; cv.height = H;
let cam = null, meta = null, busy = false, dirty = true, moving = 0;
async function init() {
  meta = await (await fetch('meta')).json();
  cam = meta.init_cam;
  const sel = document.getElementById('travel');
  for (const t of meta.travels) { const o = document.createElement('option');
    o.value = t; o.textContent = t; sel.appendChild(o); }
  for (const t of ['mean','null']) { const o = document.createElement('option');
    o.value = t; o.textContent = t; sel.appendChild(o); }
  sel.onchange = () => dirty = true;
  document.getElementById('time').oninput = () => dirty = true;
  document.getElementById('output').onchange = () => dirty = true;
  document.getElementById('frustums').onchange = () => dirty = true;
  loop();
}
function viewParams() {
  return new URLSearchParams({
    px: cam.pos[0], py: cam.pos[1], pz: cam.pos[2],
    yaw: cam.yaw, pitch: cam.pitch,
    travel: document.getElementById('travel').value,
    output: document.getElementById('output').value,
    t: document.getElementById('time').value,
    lowres: moving > 0 ? 1 : 0,
  });
}
// ---- camera frustum overlays (ref viewer.py:57-540: train/eval image
// frusta, capped at 500) ------------------------------------------------
function drawFrustums() {
  const which = document.getElementById('frustums').value;
  if (which == 'off' || !meta.cameras) return;
  const cy = Math.cos(cam.yaw), sy = Math.sin(cam.yaw);
  const cp = Math.cos(cam.pitch), sp = Math.sin(cam.pitch);
  const fwd = [-cp*cy, -cp*sy, -sp];
  const right = [-sy, cy, 0];
  const up = [ right[1]*fwd[2]-right[2]*fwd[1],
               right[2]*fwd[0]-right[0]*fwd[2],
               right[0]*fwd[1]-right[1]*fwd[0] ];
  const fl = 0.8 * W;
  const proj = p => {   // world -> canvas px, null if behind
    const d = [p[0]-cam.pos[0], p[1]-cam.pos[1], p[2]-cam.pos[2]];
    const x = d[0]*right[0]+d[1]*right[1]+d[2]*right[2];
    const y = d[0]*up[0]+d[1]*up[1]+d[2]*up[2];
    const z = d[0]*fwd[0]+d[1]*fwd[1]+d[2]*fwd[2];
    if (z < 0.05) return null;
    return [W/2 + fl*x/z, H/2 - fl*y/z];
  };
  for (const c of meta.cameras) {
    if (which != 'all' && c.split != which) continue;
    ctx2.strokeStyle = c.split == 'train' ? '#33ddff88' : '#ffaa3388';
    ctx2.lineWidth = 1;
    // frustum: apex + 4 image-plane corners at depth s
    const s = 0.6, a = c.c2w;  // row-major 3x4
    const o = [a[3], a[7], a[11]];
    const ax = [a[0], a[4], a[8]], ay = [a[1], a[5], a[9]], az = [a[2], a[6], a[10]];
    const corners = [];
    for (const [u, v] of [[-1,-1],[1,-1],[1,1],[-1,1]]) {
      // scene-frame camera looks along -z; half-angles from aspect
      corners.push([
        o[0] + s*(u*0.5*ax[0] + v*0.3*ay[0] - az[0]),
        o[1] + s*(u*0.5*ax[1] + v*0.3*ay[1] - az[1]),
        o[2] + s*(u*0.5*ax[2] + v*0.3*ay[2] - az[2])]);
    }
    const po = proj(o), pc = corners.map(proj);
    if (!po || pc.some(p => !p)) continue;
    ctx2.beginPath();
    for (let i = 0; i < 4; i++) {
      ctx2.moveTo(po[0], po[1]); ctx2.lineTo(pc[i][0], pc[i][1]);
      ctx2.moveTo(pc[i][0], pc[i][1]);
      ctx2.lineTo(pc[(i+1)%4][0], pc[(i+1)%4][1]);
    }
    ctx2.stroke();
  }
}
async function loop() {
  while (true) {
    if (dirty && !busy) {
      busy = true; dirty = false;
      const t0 = performance.now();
      try {
        const r = await fetch('render?' + viewParams());
        const blob = await r.blob();
        const img = await createImageBitmap(blob);
        ctx2.drawImage(img, 0, 0, W, H);
        drawFrustums();
        document.getElementById('fps').textContent =
          (1000/(performance.now()-t0)).toFixed(1) + ' fps';
      } catch (e) {}
      if (moving > 0) { moving--; dirty = true; }
      busy = false;
    }
    await new Promise(r => setTimeout(r, 15));
  }
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => { drag = null; moving = 0; dirty = true; };
window.onmousemove = e => {
  if (!drag) return;
  cam.yaw -= (e.clientX - drag[0]) * 0.005;
  cam.pitch -= (e.clientY - drag[1]) * 0.005;
  drag = [e.clientX, e.clientY]; moving = 2; dirty = true;
};
cv.onwheel = e => {
  const d = Math.sign(e.deltaY) * 1.0;
  cam.pos[0] += d * Math.cos(cam.pitch) * Math.cos(cam.yaw);
  cam.pos[1] += d * Math.cos(cam.pitch) * Math.sin(cam.yaw);
  cam.pos[2] += d * Math.sin(cam.pitch);
  moving = 2; dirty = true; e.preventDefault();
};
window.onkeydown = e => {
  const s = e.shiftKey ? 3.0 : 0.8;
  const fwd = [ -Math.cos(cam.pitch)*Math.cos(cam.yaw),
                -Math.cos(cam.pitch)*Math.sin(cam.yaw),
                -Math.sin(cam.pitch) ];
  const right = [ -Math.sin(cam.yaw), Math.cos(cam.yaw), 0 ];
  const k = e.key.toLowerCase();
  if (k=='w') cam.pos = cam.pos.map((v,i)=>v+fwd[i]*s);
  if (k=='s') cam.pos = cam.pos.map((v,i)=>v-fwd[i]*s);
  if (k=='a') cam.pos = cam.pos.map((v,i)=>v-right[i]*s);
  if (k=='d') cam.pos = cam.pos.map((v,i)=>v+right[i]*s);
  if (k=='q') cam.pos[2] -= s;
  if (k=='e') cam.pos[2] += s;
  moving = 2; dirty = true;
};
// ---- render panel: keyframed camera path editor ----------------------
// Exports the nerfstudio-style camera_path JSON consumed by
// mtgs_torch.tools.render.render_camera_path.
let keyframes = [];
// default export fov = the live view's actual vertical FOV (the server
// renders with fy = 0.8*W), so exported paths match what was framed
document.getElementById('fov').value =
  (2 * Math.atan((H / 2) / (0.8 * W)) * 180 / Math.PI).toFixed(1);
function c2wOf(p, yaw, pitch) {
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const fwd = [-cp*cy, -cp*sy, -sp];
  const right = [-sy, cy, 0];
  const up = [ right[1]*fwd[2]-right[2]*fwd[1],
               right[2]*fwd[0]-right[0]*fwd[2],
               right[0]*fwd[1]-right[1]*fwd[0] ];
  return [ right[0], up[0], -fwd[0], p[0],
           right[1], up[1], -fwd[1], p[1],
           right[2], up[2], -fwd[2], p[2],
           0, 0, 0, 1 ];
}
document.getElementById('addkf').onclick = () => {
  keyframes.push({pos:[...cam.pos], yaw:cam.yaw, pitch:cam.pitch});
  document.getElementById('kfn').textContent = keyframes.length + ' kf';
};
document.getElementById('clearkf').onclick = () => {
  keyframes = [];
  document.getElementById('kfn').textContent = '0 kf';
};
document.getElementById('exportkf').onclick = () => {
  if (keyframes.length < 2) { alert('need >= 2 keyframes'); return; }
  const secs = +document.getElementById('secs').value;
  const pfps = +document.getElementById('pathfps').value;
  const fov = +document.getElementById('fov').value;
  const n = Math.max(Math.round(secs * pfps), 2);
  const frames = [];
  for (let i = 0; i < n; i++) {
    const u = i / (n - 1) * (keyframes.length - 1);
    const k = Math.min(Math.floor(u), keyframes.length - 2), f = u - k;
    const a = keyframes[k], b = keyframes[k + 1];
    const lerp = (x, y) => x + (y - x) * f;
    // keep yaw interpolation on the short arc
    let dyaw = b.yaw - a.yaw;
    dyaw -= Math.round(dyaw / (2*Math.PI)) * 2*Math.PI;
    frames.push({
      camera_to_world: c2wOf(
        [lerp(a.pos[0], b.pos[0]), lerp(a.pos[1], b.pos[1]),
         lerp(a.pos[2], b.pos[2])],
        a.yaw + dyaw * f, lerp(a.pitch, b.pitch)),
      fov: fov,
    });
  }
  const spec = { render_width: W, render_height: H, seconds: secs,
                 fps: pfps, camera_path: frames };
  const blob = new Blob([JSON.stringify(spec, null, 1)],
                        {type: 'application/json'});
  const a2 = document.createElement('a');
  a2.href = URL.createObjectURL(blob);
  a2.download = 'camera_path.json';
  a2.click();
};
init();
</script></body></html>
"""

JPEG_QUALITY = 85      # the JAX viewer's PIL quality
MAX_CAMERAS = 500      # frustum overlays, as the reference viewer caps them
LOWRES_SCALE = 4       # the moving rung: 1/4 of the width and height
OUTPUTS = ("rgb", "depth", "accumulation", "normal")


class ViewerServer:
    """Render server over a trained (params, aux) scene on `device`."""

    def __init__(self, params, aux, cfg: TrainerConfig, *, travels=None,
                 init_pos=(0.0, 0.0, 2.0), frame_of_travel: Optional[Dict[int, int]] = None,
                 cameras: Optional[list] = None, device="cuda"):
        """`cameras`: optional list of dataset camera dicts
        {c2w: 3x4 row-major list, split: 'train'|'eval'} rendered as
        frustum overlays (the reference viewer shows up to 500 image
        frusta with a train/eval toggle, `viewer.py:57-540`)."""
        self.device = resolve_device(device)
        self.params = params
        self.aux = aux
        self.cfg = cfg
        self.travels = travels if travels is not None else [0]
        self.frame_of_travel = frame_of_travel or {}
        self.init_pos = list(init_pos)
        self.cameras = (cameras or [])[:MAX_CAMERAS]
        self._lock = threading.Lock()
        self._configs: Dict[Tuple[str, int], TrainerConfig] = {}

    def _get_cfg(self, mode: str, scale: int) -> TrainerConfig:
        """The render config of a (travel mode, rung): the JAX `_get_fn`'s,
        whose jitted function has no counterpart (torch keeps shapes
        dynamic)."""
        key = (mode, scale)
        if key not in self._configs:
            cfg = self.cfg.replace(
                width=self.cfg.width // scale, height=self.cfg.height // scale,
                max_intersections=max(self.cfg.max_intersections // scale, 1 << 14),
            )
            self._configs[key] = cfg.replace(scene=dataclasses.replace(
                cfg.scene, interp_poses=True,
                travel_mode=mode if mode in ("mean", "null") else "index",
            ))
        return self._configs[key]

    def request(self, q: Dict[str, str]) -> Tuple[str, int, Batch, str]:
        """A `/render` query -> (travel mode, rung scale, the view's Batch,
        output kind): the scene-frame camera from yaw/pitch (looking along
        -z), intrinsics 0.8 W, the traversal's first frame."""
        pos = [float(q.get("px", 0)), float(q.get("py", 0)), float(q.get("pz", 2))]
        yaw = float(q.get("yaw", 0.0))
        pitch = float(q.get("pitch", 0.0))
        travel_s = q.get("travel", str(self.travels[0]))
        mode = travel_s if travel_s in ("mean", "null") else "index"
        travel = int(travel_s) if mode == "index" else 0
        t = float(q.get("t", 0.0))
        scale = LOWRES_SCALE if q.get("lowres", "0") == "1" else 1

        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        fwd = np.array([-cp * cy, -cp * sy, -sp])
        right = np.array([-sy, cy, 0.0])
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0] = right
        c2w[:3, 1] = up
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = pos

        W, H = self.cfg.width // scale, self.cfg.height // scale
        K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1.0]], np.float32)
        # render_view reads no image, mask or depth when not training
        batch = Batch(
            image=np.zeros((1, 1, 3), np.float32), mask=np.ones((1, 1, 1), np.float32),
            c2w=c2w, K=K, cam_idx=0, image_idx=0, travel_index=travel,
            frame_idx=self.frame_of_travel.get(travel, 0), timestamp=t,
        )
        return mode, scale, batch, q.get("output", "rgb")

    def render_outputs(self, mode: str, scale: int, batch: Batch) -> Dict[str, torch.Tensor]:
        """The four viewer outputs of one view, on the device."""
        cfg = self._get_cfg(mode, scale)
        out = render_view(self.params, self.aux, cfg, batch, 10**9, training=False,
                          travel_mode=cfg.scene.travel_mode, device=self.device)
        return dict(
            rgb=out["rgb_appearance"],
            depth=out["depth"],
            accumulation=out["accumulation"],
            normal=out.get("normal", out["rgb_appearance"]),
        )

    @staticmethod
    def _colorize(out: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
        """Output-type selection + colormapping (the reference viewer's
        output dropdown over the model's outputs dict), on the outputs'
        device: [H, W, 3] in [0, 1]. The depth ramp spans the 2nd to 98th
        percentile (linear interpolation, numpy's default) of the depth
        where accumulation > 0.5, in float64 as numpy computes it."""
        if kind == "depth":
            d = out["depth"][..., 0].double()
            covered = d[out["accumulation"][..., 0] > 0.5]
            lo, hi = 0.0, 1.0
            if covered.numel():
                q = torch.tensor([0.02, 0.98], dtype=torch.float64, device=d.device)
                lo, hi = torch.quantile(covered, q).tolist()
            t = torch.clamp((d - lo) / max(hi - lo, 1e-6), 0, 1)
            # simple turbo-ish ramp (blue -> green -> red)
            rgb = torch.stack([t, 1.0 - torch.abs(2 * t - 1.0), 1.0 - t], dim=-1)
            return torch.clamp(rgb, 0, 1)
        if kind == "accumulation":
            return torch.clamp(out["accumulation"], 0, 1).repeat(1, 1, 3)
        if kind == "normal":
            return torch.clamp(out["normal"][..., :3], 0, 1)
        return torch.clamp(out["rgb"], 0, 1)

    def frame(self, out: Dict[str, torch.Tensor], kind: str) -> np.ndarray:
        """The uint8 [H, W, 3] frame of an output kind: coloured on the
        device, truncated to 8 bits, and only that copied to the host."""
        return (self._colorize(out, kind) * 255).to(torch.uint8).cpu().numpy()

    def render(self, q: Dict[str, str]) -> bytes:
        """A `/render` query -> the JPEG bytes of its frame."""
        mode, scale, batch, kind = self.request(q)
        with self._lock:
            out = self.render_outputs(mode, scale, batch)
        return encode_jpeg(self.frame(out, kind), quality=JPEG_QUALITY)

    def export(self, fmt: str) -> Tuple[bytes, str]:
        """In-viewer export panel (ref `export_panel.py`): background node
        -> ply / splat / point-cloud bytes."""
        fns = {"ply": (export_ply, "scene.ply"),
               "splat": (export_splat, "scene.splat"),
               "pcd": (export_point_cloud, "points.ply")}
        if fmt not in fns:
            raise ValueError(f"unknown export format {fmt}")
        fn, name = fns[fmt]
        with tempfile.TemporaryDirectory() as td:
            p = fn(self.params.background, self.aux.background, Path(td) / name)
            return p.read_bytes(), name

    def make_server(self, port: int = 7007, host: str = "0.0.0.0") -> ThreadingHTTPServer:
        """The HTTP server bound to (host, port), not yet serving: `/` the
        page, `/meta` the travels, start camera and frusta, `/render` a
        JPEG frame, `/export` a gaussian file; 404 for any other path, 500
        with the message when a request raises."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                try:
                    if url.path in ("/", "/index.html"):
                        body = _PAGE.encode()
                        ctype = "text/html"
                    elif url.path == "/meta":
                        body = json.dumps({
                            "travels": [int(t) for t in viewer.travels],
                            "init_cam": {"pos": viewer.init_pos, "yaw": 0.0, "pitch": 0.0},
                            "cameras": viewer.cameras,
                        }).encode()
                        ctype = "application/json"
                    elif url.path == "/render":
                        body = viewer.render(q)
                        ctype = "image/jpeg"
                    elif url.path == "/export":
                        body, name = viewer.export(q.get("format", "ply"))
                        self.send_response(200)
                        self.send_header("Content-Type", "application/octet-stream")
                        self.send_header(
                            "Content-Disposition", f'attachment; filename="{name}"')
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass
                except Exception as e:  # the boundary: report the failure to the client
                    msg = str(e).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, port: int = 7007, host: str = "0.0.0.0"):
        server = self.make_server(port, host)
        print(f"[viewer] http://{host}:{server.server_port}/")
        server.serve_forever()


def viewer_from_run(run, *, data=None, device="cuda") -> ViewerServer:
    """A viewer over a run written by `mtgs_torch.tools.train_scene`
    (reloaded by its `eval_setup`): its traversals, the first frame of each,
    the start camera 2 m above the seed cloud's median, and every dataset
    camera as a train/eval frustum (capped at MAX_CAMERAS)."""
    from mtgs_torch.tools.train_scene import eval_setup

    params, aux, cfg, scene, _ = eval_setup(run, data=data, device=device)
    frame_of_travel: Dict[int, int] = {}
    for r in scene.records:
        frame_of_travel.setdefault(int(r.travel_index), int(r.frame_idx))
    center = np.zeros(3)
    if scene.seed_xyz is not None and len(scene.seed_xyz):
        center = np.median(np.asarray(scene.seed_xyz), axis=0)
    train_ids = set(scene.train_travel_ids)
    cameras = [
        {
            "c2w": np.asarray(r.c2w, np.float32)[:3].reshape(-1).tolist(),
            "split": "train" if r.travel_id in train_ids else "eval",
        }
        for r in scene.records
    ]
    return ViewerServer(
        params, aux, cfg,
        travels=sorted({int(r.travel_index) for r in scene.records}),
        init_pos=(float(center[0]), float(center[1]), float(center[2]) + 2.0),
        frame_of_travel=frame_of_travel,
        cameras=cameras,
        device=device,
    )


def main(argv=None):
    """`run_viewer.py` equivalent: reload a trained run and serve it."""
    ap = argparse.ArgumentParser(description="Serve a trained run in the browser.")
    ap.add_argument("--run", required=True,
                    help="run dir written by mtgs_torch.tools.train_scene "
                         "(run_config.json + step-* checkpoints)")
    ap.add_argument("--data", default=None,
                    help="override the dataset root recorded in the run")
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cpu only when asked for)")
    args = ap.parse_args(argv)
    viewer_from_run(args.run, data=args.data, device=args.device).serve(port=args.port)


if __name__ == "__main__":
    main()
