"""Host-side visualization and trajectory dumping: the port's counterpart
of ``tpu_locoman/viz.py``.

Trajectory dumps (JSON) for any external viewer, a self-contained 3D
skeleton player, a live viewer over a stdlib HTTP server and the
matplotlib joint plots (import-gated: matplotlib is imported inside
``plot_joint_trajectories`` only). The skeleton's points come from the
port's forward kinematics (``rbda.fk``), batched over the trajectory on
``device`` (the card unless the caller passes ``device="cpu"``).
"""

import json

import numpy as np
import torch


def dump_trajectory(path, q_traj, dt, v_traj=None, tau_traj=None):
    """Write an executed trajectory for offline replay (the MeshCat-replay
    analog, run_mpc.py:270-273)."""
    out = {"dt": float(dt), "q": _np(q_traj).tolist()}
    if v_traj is not None:
        out["v"] = _np(v_traj).tolist()
    if tau_traj is not None:
        out["tau"] = _np(tau_traj).tolist()
    with open(path, "w") as f:
        json.dump(out, f)
    return path


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def positions(model, q, frame_names=(), device="cuda"):
    """World positions (..., n_links + n_frames, 3) float32 numpy of every
    link frame and then of each named frame, for q (..., nq), by the
    port's forward kinematics on ``device``."""
    from . import rbda
    from .mpc import _device

    q = torch.as_tensor(_np(q), dtype=torch.float32, device=_device(device))
    with torch.no_grad():
        R_w, p_w = rbda.fk(model, q)
        pts = [p_w] + [rbda.frame_placement(model, name, R_w, p_w)[1][
            ..., None, :] for name in frame_names]
        return torch.cat(pts, -2).cpu().numpy()


def _skeleton(model, frame_names):
    """(edges, markers, names) of the tree and the named frames, attached
    to their parent joints."""
    n = model.n_links
    edges = [[int(model.parent[i]), i] for i in range(1, n)]
    markers = []
    for k, name in enumerate(frame_names):
        edges.append([int(model.frames[name].parent_joint), n + k])
        markers.append(n + k)
    return edges, markers, [f"link{i}" for i in range(n)] + list(frame_names)


def dump_scene(path, model, q_traj, dt, frame_names=(), device="cuda"):
    """Write a 3D replay scene: per-tick world positions of every link
    frame plus the tree edges — everything a skeleton viewer needs, no
    meshes required.

    The MeshCat-replay analog (reference run_mpc.py:270-273) for a
    zero-egress environment: pair with write_player_html for an
    interactive in-browser replay.
    """
    pts = positions(model, q_traj, frame_names, device)
    edges, markers, names = _skeleton(model, frame_names)
    out = {
        "dt": float(dt),
        "points": pts.tolist(),  # (T, n_links + n_frames, 3)
        "edges": edges,
        "markers": markers,
        "names": names,
    }
    with open(path, "w") as f:
        json.dump(out, f)
    return path


_PLAYER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpu-locoman replay</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace}
 #hud{position:fixed;top:8px;left:8px}
 canvas{display:block}
 button{background:#333;color:#ddd;border:1px solid #555;margin-right:4px}
</style></head><body>
<div id="hud"><button id="play">pause</button>
<span id="t"></span> — drag to orbit, wheel to zoom</div>
<canvas id="c"></canvas>
<script>
const SCENE = __SCENE__;
const LIVE = __LIVE__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W,H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs(); addEventListener('resize', rs);
let yaw=0.8, pitch=0.35, zoom=420, cx=0, playing=true, ti=0;
cv.onmousedown=e=>{let px=e.clientX,py=e.clientY;
 const mv=ev=>{yaw+=(ev.clientX-px)*0.01;pitch+=(ev.clientY-py)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch));px=ev.clientX;py=ev.clientY;};
 const up=()=>{removeEventListener('mousemove',mv);removeEventListener('mouseup',up);};
 addEventListener('mousemove',mv);addEventListener('mouseup',up);};
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);};
document.getElementById('play').onclick=function(){playing=!playing;
 this.textContent=playing?'pause':'play';};
function proj(p){
 const x=p[0]-cx, y=p[1], z=p[2];
 const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
 const x1=cy*x+sy*y, y1=-sy*x+cy*y;           // yaw about z
 const y2=cp*y1-sp*z, z2=sp*y1+cp*z;          // pitch
 return [W/2+zoom*x1, H*0.55-zoom*z2, y2];
}
function grid(){
 ctx.strokeStyle='#2a2a2a';
 for(let i=-10;i<=10;i++){
  let a=proj([i*0.25,-2.5,0]), b=proj([i*0.25,2.5,0]);
  ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
  a=proj([-2.5,i*0.25,0]); b=proj([2.5,i*0.25,0]);
  ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();}
}
function draw(){
 ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
 const pts=SCENE.points[ti]; cx=pts[0][0];
 grid();
 ctx.strokeStyle='#6cf'; ctx.lineWidth=2;
 for(const [a,b] of SCENE.edges){
  const pa=proj(pts[a]), pb=proj(pts[b]);
  ctx.beginPath();ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
 for(let i=0;i<pts.length;i++){
  const p=proj(pts[i]);
  ctx.fillStyle=SCENE.markers.includes(i)?'#f80':'#fff';
  ctx.beginPath();ctx.arc(p[0],p[1],SCENE.markers.includes(i)?4:2.5,0,7);ctx.fill();}
 document.getElementById('t').textContent=
  't='+(ti*SCENE.dt).toFixed(2)+'s  tick '+ti+'/'+(SCENE.points.length-1);
}
let lastSeq=-1;
async function liveTick(){
 try{
  const r=await fetch('/frame?since='+lastSeq);
  if(r.status===200){const f=await r.json();lastSeq=f.seq;
   SCENE.points=[f.points];ti=0;
   document.getElementById('t').textContent='live frame '+f.seq;}
 }catch(e){}
 draw();
}
setInterval(()=>{
 if(LIVE){liveTick();return;}
 if(playing){ti=(ti+1)%SCENE.points.length;} draw();},
            Math.max(16, SCENE.dt*1000));
</script></body></html>
"""


def write_player_html(path, scene_path):
    """Emit a self-contained interactive 3D skeleton player (vanilla
    canvas — the environment has no CDN access for three.js) with the
    scene JSON inlined. Open in any browser."""
    with open(scene_path) as f:
        scene = f.read()
    with open(path, "w") as f:
        f.write(_PLAYER_HTML.replace("__SCENE__", scene)
                .replace("__LIVE__", "false"))
    return path


class LiveViewer:
    """Live streaming 3D viewer — the MeshCat live-display analog
    (reference run_mpc.py:163-165: `robot.init_visualizer()` +
    per-tick `display(q)`).

    A stdlib threaded HTTP server on localhost serves the skeleton player
    in live mode; the control loop calls push(q) each tick and the page
    polls /frame (long-poll-free: 204 when unchanged). Zero external
    dependencies, works through an ssh port-forward from a headless host.

    Endpoints: `/` player HTML, `/frame?since=N` latest frame JSON
    {seq, points}, `/scene` static skeleton metadata.
    """

    def __init__(self, model, frame_names=(), dt=0.02, port=0,
                 device="cuda"):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._model = model
        self._frame_names = tuple(frame_names)
        self._device = device
        edges, markers, names = _skeleton(model, self._frame_names)
        zero = np.zeros((model.n_links + len(markers), 3))
        self._scene = {
            "dt": float(dt),
            "points": [zero.tolist()],
            "edges": edges,
            "markers": markers,
            "names": names,
        }
        self._lock = threading.Lock()
        self._seq = 0
        self._frame = zero.tolist()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                if u.path == "/":
                    html = (_PLAYER_HTML
                            .replace("__SCENE__", json.dumps(viewer._scene))
                            .replace("__LIVE__", "true"))
                    self._send(200, html, "text/html")
                elif u.path == "/frame":
                    since = int(parse_qs(u.query).get("since", ["-1"])[0])
                    with viewer._lock:
                        seq, frame = viewer._seq, viewer._frame
                    if seq == since:
                        self._send(204, "")
                    else:
                        self._send(200, json.dumps(
                            {"seq": seq, "points": frame}))
                elif u.path == "/scene":
                    self._send(200, json.dumps(viewer._scene))
                else:
                    self._send(404, "{}")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}/"

    def push(self, q):
        """Publish the current configuration (forward kinematics on the
        viewer's device -> points)."""
        pts = positions(self._model, q, self._frame_names, self._device)
        with self._lock:
            self._seq += 1
            self._frame = pts.tolist()
        return self._seq

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def plot_joint_trajectories(q_traj, v_traj, tau_traj, nj=12, path=None,
                            labels=None):
    """The reference's q/v/tau joint plots (run_mpc.py:243-267)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if labels is None:
        labels = [
            f"{leg} {part}"
            for leg in ["FL", "FR", "RL", "RR"]
            for part in ["hip", "thigh", "calf"]
        ]
    q_traj = _np(q_traj)
    v_traj = _np(v_traj)
    tau_traj = _np(tau_traj)

    fig, axs = plt.subplots(3, 1, figsize=(10, 15))
    axs[0].set_title("Joint positions (q)")
    for j in range(nj):
        axs[0].plot(q_traj[:, 7 + j], label=labels[j % len(labels)])
    axs[1].set_title("Joint velocities (v)")
    for j in range(nj):
        axs[1].plot(v_traj[:, 6 + j], label=labels[j % len(labels)])
    axs[2].set_title("Joint torques (tau)")
    for j in range(nj):
        axs[2].plot(tau_traj[:, j], label=labels[j % len(labels)])
    for ax in axs:
        ax.legend(fontsize=6, ncol=4)
    plt.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path
    return fig
