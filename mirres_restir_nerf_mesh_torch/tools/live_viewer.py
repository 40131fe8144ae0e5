"""Interactive orbit viewer (counterpart of scripts/live_viewer.py, the
analogue of the upstream project's GUI): a browser page with mouse-orbit
controls; every drag requests /render?theta=..&phi=..&radius=..&mode=..,
rendered through the port (the stage-0 volume render from a checkpoint, or
the stage-1 mesh with its path tracer / ReSTIR) and served as a JPEG
(quality 90, the port's encoder: no PIL).

    python3 -m mirres_restir_nerf_mesh_torch.tools.live_viewer --workspace ws/ --stage 0 [--port 8000]
    python3 -m mirres_restir_nerf_mesh_torch.tools.live_viewer --workspace ws/ --stage 1 --use_brdf

Train while viewing (the upstream GUI's train mode): ``--train`` runs the
Trainer's loop in a daemon thread of this process, and each render reads
the live state between steps, so the view sharpens as the run goes on.
Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
``--port 0`` takes a free port (printed, and in ``_SERVER_FOR_TEST``).
"""

from __future__ import annotations

import argparse
import threading

import numpy as np

PAGE = """<!doctype html>
<html><head><title>mirres-tpu live viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#v{display:block;margin:12px auto;border:1px solid #333;cursor:grab}
#s{text-align:center}</style></head><body>
<div id=s>drag to orbit &middot; wheel to zoom &middot;
<select id=m>__MODES__</select> &middot; <span id=t></span></div>
<img id=v width=__W__ height=__H__>
<script>
let th=1.2, ph=0.5, r=2.2, busy=false, dirty=true;
const img=document.getElementById('v'), lab=document.getElementById('t');
const sel=document.getElementById('m'); sel.onchange=()=>dirty=true;
function tick(){
  if(!busy && dirty){
    busy=true; dirty=false;
    const t0=performance.now();
    const u=`/render?theta=${th.toFixed(3)}&phi=${ph.toFixed(3)}&radius=${r.toFixed(3)}&mode=${sel.value}&_=${Math.random()}`;
    const i=new Image();
    i.onload=()=>{img.src=i.src;lab.textContent=`${(performance.now()-t0).toFixed(0)} ms`;busy=false;};
    i.onerror=()=>{busy=false;};
    i.src=u;
  }
  requestAnimationFrame(tick);
}
let drag=false,lx=0,ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return; ph+=(e.clientX-lx)*0.01; th-=(e.clientY-ly)*0.01;
  th=Math.max(0.1,Math.min(3.0,th)); lx=e.clientX; ly=e.clientY; dirty=true;};
img.onwheel=e=>{e.preventDefault(); r*=Math.exp(e.deltaY*0.001); r=Math.max(0.5,Math.min(6,r)); dirty=true;};
tick();
</script></body></html>"""

JPEG_QUALITY = 90

# set by main() so a caller in the same process can watch the training
# progress and shut the server down
_TRAINER_FOR_TEST = None
_SERVER_FOR_TEST = None


def _viz(out: dict, mode: str, H: int, W: int) -> np.ndarray:
    """A render's buffer as an [H, W, 3] image in [0, 1]-ish floats."""
    def a(k):
        v = out[k]
        return v.float().cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)

    m = a("mask").reshape(H, W, 1) if "mask" in out else None
    if mode == "depth":
        d = a("depth").reshape(H, W, 1)
        live = d[np.isfinite(d) & (d > 0)] if m is None else d[m[..., 0] > 0.5]
        lo, hi = (live.min(), live.max()) if live.size else (0.0, 1.0)
        d = np.where(np.isfinite(d), (d - lo) / max(hi - lo, 1e-6), 1.0)
        return np.repeat(1.0 - np.clip(d, 0, 1), 3, axis=-1)
    if mode == "normal":
        return np.where(m > 0.5, a("normal").reshape(H, W, 3) * 0.5 + 0.5, 1.0)
    if mode in ("kd", "ks"):
        return np.where(m > 0.5, a(mode).reshape(H, W, 3), 1.0)
    if mode == "diffuse":
        kd = a("kd").reshape(H, W, 3)
        metal = a("ks").reshape(H, W, 3)[..., 2:3]
        return np.where(m > 0.5, kd * (1 - metal) * a("diffuse_light").reshape(H, W, 3), 1.0)
    if mode == "specular":
        return np.where(m > 0.5, a("specular_light").reshape(H, W, 3), 1.0)
    if mode == "indirect":
        return np.where(m > 0.5, a("img_brdf_indirect").reshape(H, W, 3), 1.0)
    return a(mode).reshape(H, W, 3)


def main(argv=None, device="cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--use_brdf", action="store_true")
    ap.add_argument("--use_restir", action="store_true")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--fp16", action="store_true")
    ap.add_argument("--hash_levels", type=int, default=16)
    ap.add_argument("--hash_log2_size", type=int, default=19)
    ap.add_argument("--hash_max_res", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="run the Trainer loop in a daemon thread and view the live state")
    ap.add_argument("--data", type=str, default="",
                    help="dataset path for --train (blender/colmap/dtu; default: the "
                         "synthetic sphere scene)")
    ap.add_argument("--data_format", type=str, default="nerf")
    ap.add_argument("--iters", type=int, default=0,
                    help="training iterations for --train (0 = config default)")
    args = ap.parse_args(argv)

    import torch

    from ..config import Config, finalize
    from ..data.rays import get_rays
    from ..data.synthetic import make_synthetic_frames, orbit_pose
    from ..render.stage1 import render_stage1
    from ..train import stage0
    from ..train.trainer import Trainer
    from ..utils.image_io import encode_jpeg

    H = W = args.size
    fx = 0.8 * W
    intr = np.array([fx, fx, W / 2.0, H / 2.0], np.float32)
    common = dict(workspace=args.workspace, stage=args.stage, bound=args.bound,
                  use_brdf=args.use_brdf, use_restir=args.use_restir, spp=args.spp, ssaa=1,
                  data_parallel=False, fp16=args.fp16, hash_levels=args.hash_levels,
                  hash_log2_size=args.hash_log2_size, hash_max_res=args.hash_max_res)
    if args.train:
        cfg = finalize(Config(**common, path=args.data, data_format=args.data_format,
                              **({"iters": args.iters} if args.iters else {})))
        if args.data:
            from ..main import load_dataset

            data = load_dataset(cfg, cfg.train_split)
        else:
            data = make_synthetic_frames(n_frames=8, H=H, W=W, bound=args.bound)
    else:
        cfg = finalize(Config(**common))
        # the Trainer needs a dataset only for its shapes
        data = make_synthetic_frames(n_frames=1, H=H, W=W, bound=args.bound)
    trainer = Trainer("ngp", cfg, data, device=device)
    dev = trainer.device
    global _TRAINER_FOR_TEST
    _TRAINER_FOR_TEST = trainer
    lock = threading.Lock()

    if args.train:
        # one process, one card: the loop runs in a daemon thread and the
        # renders read the trainer's live state between its steps
        threading.Thread(target=trainer.train, daemon=True).start()
        print("[viewer] training in background; renders track the live state", flush=True)

    # buffer modes: the upstream GUI's image / depth and shading modes, and
    # the material / normal buffers stage 1 returns
    if args.stage == 0:
        modes = ("image", "depth")
    else:
        modes = ("image_brdf", "image", "depth", "normal", "kd", "ks",
                 "diffuse", "specular", "indirect")
        if not args.use_brdf:
            modes = ("image",) + tuple(m for m in modes if m != "image")

    @torch.no_grad()
    def render(theta: float, phi: float, radius: float, mode: str) -> np.ndarray:
        mode = mode if mode in modes else modes[0]
        pose = torch.as_tensor(orbit_pose(theta, phi, radius=radius), device=dev)
        rays = get_rays(pose[None], intr, H, W)
        rays_o, rays_d = rays["rays_o"].contiguous(), rays["rays_d"].contiguous()
        with lock:
            if args.stage == 0:
                img, depth = stage0.render_frame(trainer.state, trainer.render_fn, rays_o,
                                                 rays_d, H, W)
                out = {"image": img, "depth": depth}
            else:
                out = render_stage1(trainer.state.params, trainer.static,
                                    trainer._base_verts_t, rays_o, rays_d,
                                    generator=torch.Generator(device=dev).manual_seed(0))
            img = _viz(out, mode, H, W)
        return np.clip(np.asarray(img, np.float32), 0, 1)

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, kind: str, body: bytes) -> None:
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                opts = "".join(f"<option>{m}</option>" for m in modes)
                self._send("text/html", PAGE.replace("__W__", str(W)).replace("__H__", str(H))
                           .replace("__MODES__", opts).encode())
                return
            if u.path == "/render":
                q = parse_qs(u.query)
                img = render(float(q.get("theta", [1.2])[0]), float(q.get("phi", [0.5])[0]),
                             float(q.get("radius", [2.2])[0]), q.get("mode", [modes[0]])[0])
                self._send("image/jpeg", encode_jpeg((img * 255).astype(np.uint8), JPEG_QUALITY))
                return
            self.send_response(404)
            self.end_headers()

    global _SERVER_FOR_TEST
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    _SERVER_FOR_TEST = srv     # a caller in this process shuts it down with .shutdown()
    print(f"[viewer] http://localhost:{srv.server_address[1]}", flush=True)
    srv.serve_forever()
    srv.server_close()


if __name__ == "__main__":
    main()
