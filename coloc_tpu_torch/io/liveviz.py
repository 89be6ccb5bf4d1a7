"""Live pose + map view (counterpart of coloc_tpu.io.liveviz).

Reference parity: rosUtils.hpp:29-67 publishes per-drone
`geometry_msgs::PoseStamped` topics (`coloc/drone{i}/pose`) and a PCL
point-cloud map (`coloc/map`) for the RViz layout in coloc.rviz. Without
ROS, the operator view is a dependency-free HTTP streamer:

  - a background stdlib http.server thread serves a single-page viewer
    (canvas: top-down X/Z and side X/Y projections, drone trails, the
    landmark cloud) at `/`,
  - `/state.json` returns the latest per-drone poses (with the position
    covariance) and the landmark cloud; the page polls it at ~10 Hz.

The session pushes updates through `publish_pose` / `publish_map` (the
publishMsgs analog) when constructed with `viz=LiveViz(...)`. Values are
host numpy (a session copies its tensors to the host first).

View configuration (the coloc.rviz analog): the layout knobs live in a
JSON view config served at `/view.json` and applied by the page on load.
`coloc.view.json` at the repo root is the default layout; pass a dict or a
path as `LiveViz(view_config=...)` to override. Recognized keys (all
optional):
  trail       int   pose-trail length per drone       (default 500)
  point_size  int   landmark pixel size               (default 2)
  views       list  any of "xz" (top-down), "xy" (side), "zy"
                    (default ["xz", "xy"])
  bounds      [lo_x, hi_x, lo_v, hi_v] fixed view bounds instead of
              auto-fit (default null = auto-fit)
  background  str   canvas CSS color                  (default "#181818")
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import numpy as np

from coloc_tpu_torch.io import decimate_map_points

_DEFAULT_VIEW = {
    "trail": 500,
    "point_size": 2,
    "views": ["xz", "xy"],
    "bounds": None,
    "background": "#181818",
}

_PAGE = """<!DOCTYPE html>
<html><head><title>coloc_tpu live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:0}
#hud{padding:6px 10px}
canvas{display:block;margin:0 auto;background:#181818}
.d0{color:#6cf}.d1{color:#fc6}.d2{color:#6f9}.d3{color:#f6a}
</style></head><body>
<div id="hud">coloc_tpu live viz &mdash; waiting for data...</div>
<canvas id="cv" width="1200" height="600"></canvas>
<script>
const colors=['#6cf','#fc6','#6f9','#f6a','#c6f','#ff6'];
let trails={};
// view config (coloc.rviz analog): fetched once, defaults if unavailable
let VIEW={trail:500,point_size:2,views:['xz','xy'],bounds:null,background:'#181818'};
const SEL={xz:(p)=>[p[0],p[2]], xy:(p)=>[p[0],p[1]], zy:(p)=>[p[2],p[1]]};
fetch('view.json').then(r=>r.json()).then(v=>{Object.assign(VIEW,v);
  document.getElementById('cv').style.background=VIEW.background;
  document.getElementById('cv').width=600*VIEW.views.length;}).catch(()=>{});
async function tick(){
  let st;
  try{ st=await (await fetch('state.json')).json(); }catch(e){ return; }
  const cv=document.getElementById('cv'),g=cv.getContext('2d');
  g.clearRect(0,0,cv.width,cv.height);
  const pts=st.map||[], poses=st.poses||{};
  for(const d in poses){ (trails[d]=trails[d]||[]).push(poses[d].C);
    if(trails[d].length>VIEW.trail) trails[d].shift(); }
  // bounds over map + trails (or the view config's fixed bounds)
  let xs=[],ys=[],zs=[];
  for(const p of pts){xs.push(p[0]);ys.push(p[1]);zs.push(p[2]);}
  for(const d in trails) for(const c of trails[d]){xs.push(c[0]);ys.push(c[1]);zs.push(c[2]);}
  if(!xs.length) return;
  const lo=a=>Math.min(...a), hi=a=>Math.max(...a);
  const mk=(w,h,x0,x1,y0,y1)=>{const s=0.9*Math.min(w/Math.max(x1-x0,1e-6),h/Math.max(y1-y0,1e-6));
    return (x,y)=>[ (x-(x0+x1)/2)*s+w/2, (y-(y0+y1)/2)*s+h/2 ];};
  const axes={x:xs,y:ys,z:zs};
  const views=VIEW.views.map((name,i)=>{
    const [ha,va]=name.split('');
    const pr=VIEW.bounds
      ? mk(600,600,VIEW.bounds[0],VIEW.bounds[1],VIEW.bounds[2],VIEW.bounds[3])
      : mk(600,600,lo(axes[ha]),hi(axes[ha]),lo(axes[va]),hi(axes[va]));
    return [pr, 600*i, SEL[name]];
  });
  for(const [pr,ox,sel] of views){
    g.fillStyle='#555';
    for(const p of pts){const[a,b]=pr(...sel(p));g.fillRect(ox+a,b,VIEW.point_size,VIEW.point_size);}
    let di=0;
    for(const d in trails){ g.strokeStyle=colors[di%6]; g.beginPath();
      trails[d].forEach((c,i)=>{const[a,b]=pr(...sel(c)); i?g.lineTo(ox+a,b):g.moveTo(ox+a,b);});
      g.stroke();
      const c=trails[d][trails[d].length-1]; const[a,b]=pr(...sel(c));
      g.fillStyle=colors[di%6]; g.beginPath(); g.arc(ox+a,b,5,0,7); g.fill();
      di++; }
    g.strokeStyle='#333'; g.strokeRect(ox,0,600,600);
  }
  let hud='frame '+(st.frame??'-')+' | map '+pts.length+' pts';
  let di=0;
  for(const d in poses){const p=poses[d];
    hud+=` | <span class="d${di%4}">d${d}: [${p.C.map(v=>v.toFixed(2))}] ${p.success?'ok':'LOST'}</span>`; di++;}
  document.getElementById('hud').innerHTML=hud;
}
setInterval(tick,100);
</script></body></html>
"""


class LiveViz:
    """Threaded HTTP pose/map streamer (ROSUtils analog)."""

    def __init__(self, port: int = 8765, host: str = "127.0.0.1",
                 max_map_points: int = 4096,
                 view_config: Union[str, dict, None] = None):
        self._lock = threading.Lock()
        self._poses = {}
        self._map = []
        self._frame = None
        self._max_map_points = max_map_points
        self.view = dict(_DEFAULT_VIEW)
        if view_config is None:
            # the repo-root layout file, if present (coloc.rviz analog)
            default_path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))), "coloc.view.json")
            if os.path.exists(default_path):
                view_config = default_path
        if isinstance(view_config, str):
            try:
                with open(view_config) as fh:
                    self.view.update(json.load(fh))
            except (OSError, ValueError) as e:
                warnings.warn(f"view config {view_config!r} ignored ({e}); "
                              "using defaults", RuntimeWarning)
        elif isinstance(view_config, dict):
            self.view.update(view_config)
        viz = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path == "/state.json":
                    body = viz._state_json().encode()
                    ctype = "application/json"
                elif self.path == "/view.json":
                    body = json.dumps(viz.view).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}/"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ publishers
    def publish_pose(self, drone: int, C, cov3=None, success: bool = True,
                     frame: Optional[int] = None):
        """Per-drone pose update (coloc/drone{i}/pose analog)."""
        entry = {
            "C": [float(v) for v in np.asarray(C).reshape(3)],
            "success": bool(success),
        }
        if cov3 is not None:
            entry["cov"] = np.asarray(cov3).reshape(3, 3).tolist()
        with self._lock:
            self._poses[int(drone)] = entry
            if frame is not None:
                self._frame = int(frame)

    def publish_map(self, X, valid=None):
        """Landmark cloud update (coloc/map analog)."""
        X = decimate_map_points(X, valid, self._max_map_points)
        with self._lock:
            self._map = np.asarray(X, np.float32).round(4).tolist()

    def _state_json(self) -> str:
        with self._lock:
            return json.dumps(
                {"poses": self._poses, "map": self._map, "frame": self._frame}
            )

    def close(self):
        self._server.shutdown()
        self._server.server_close()
