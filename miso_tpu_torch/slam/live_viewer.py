"""Live SLAM viewer: a web page served from the run (the port's own copy of
``miso_tpu/slam/live_viewer.py``, which is pure numpy and ``http.server``).

SLAM machines are headless, so instead of an X window the run serves
``http://<host>:<port>/``: a self-contained HTML page (a canvas renderer in
plain JavaScript, no external assets, no network needed) that polls
``/state.json`` and draws

  * the estimated (and optional ground-truth) trajectory,
  * the current frame's point cloud,
  * the submaps' oriented bounding boxes,
  * the latest global mesh as a decimated wireframe.

The server runs on a daemon thread; ``update`` calls from the SLAM loop swap
an immutable state dict, so serving never blocks the loop.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>miso_tpu live SLAM</title>
<style>
 body{margin:0;background:#10131a;color:#cfd8e3;font:13px sans-serif}
 #hud{position:fixed;top:8px;left:10px;white-space:pre;opacity:.85}
 canvas{display:block}
</style></head><body>
<div id="hud">connecting...</div><canvas id="c"></canvas>
<script>
"use strict";
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
let st=null,yaw=-0.7,pitch=-0.5,dist=9,cx=0,cy=0,cz=0,drag=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener("resize",resize);resize();
cv.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY]);
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{if(!drag)return;
 yaw+=(e.clientX-drag[0])*.008;pitch+=(e.clientY-drag[1])*.008;
 pitch=Math.max(-1.55,Math.min(1.55,pitch));drag=[e.clientX,e.clientY];});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*.001);});
function proj(p){
 const x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
 const cy_=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x1=cy_*x+sy*y,y1=-sy*x+cy_*y;
 const y2=cp*y1+sp*z,z2=-sp*y1+cp*z;
 const d=y2+dist;if(d<=.05)return null;
 const f=.9*Math.min(cv.width,cv.height)/d;
 return [cv.width/2+f*x1,cv.height/2-f*z2];}
function line(a,b,col,w){const A=proj(a),B=proj(b);if(!A||!B)return;
 ctx.strokeStyle=col;ctx.lineWidth=w||1;ctx.beginPath();
 ctx.moveTo(A[0],A[1]);ctx.lineTo(B[0],B[1]);ctx.stroke();}
function poly(pts,col,w){for(let i=1;i<pts.length;i++)line(pts[i-1],pts[i],col,w);}
function dots(pts,col,r){ctx.fillStyle=col;for(const p of pts){const A=proj(p);
 if(A){ctx.fillRect(A[0]-r,A[1]-r,2*r,2*r);}}}
const BOX_E=[[0,1],[0,2],[0,4],[1,3],[1,5],[2,3],[2,6],[3,7],[4,5],[4,6],[5,7],[6,7]];
function draw(){
 ctx.fillStyle="#10131a";ctx.fillRect(0,0,cv.width,cv.height);
 if(!st)return;
 if(st.traj_est&&st.traj_est.length){const t=st.traj_est;
  const last=t[t.length-1];cx+=(last[0]-cx)*.05;cy+=(last[1]-cy)*.05;cz+=(last[2]-cz)*.05;}
 for(const box of (st.submap_boxes||[]))
  for(const e of BOX_E)line(box[e[0]],box[e[1]],"#3d6fb4",1);
 if(st.mesh_edges)for(const e of st.mesh_edges)line(e[0],e[1],"#3a4b42",1);
 if(st.frame_points)dots(st.frame_points,"#d8c57a",1);
 if(st.traj_gt)poly(st.traj_gt,"#5c6670",1);
 if(st.traj_est){poly(st.traj_est,"#e05f4e",2);
  if(st.traj_est.length)dots([st.traj_est[st.traj_est.length-1]],"#ff8877",3);}
 document.getElementById("hud").textContent=
  `miso_tpu live  frame ${st.frame??"-"}  submaps ${st.num_submaps??"-"}`+
  `\\nkeyframes ${st.traj_est?st.traj_est.length:0}  drag=orbit wheel=zoom`;
}
async function tick(){try{
  const r=await fetch("state.json");st=await r.json();}catch(e){}
 draw();setTimeout(tick,700);}
tick();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    viewer: "LiveViewer" = None

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = _PAGE.encode()
            ctype = "text/html"
        elif self.path.startswith("/state.json"):
            body = self.viewer.state_json().encode()
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


class LiveViewer:
    """Threaded HTTP server publishing the live SLAM state."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 max_frame_points: int = 2000, max_mesh_edges: int = 4000):
        self.max_frame_points = max_frame_points
        self.max_mesh_edges = max_mesh_edges
        self._state: Dict = {}
        self._lock = threading.Lock()
        handler = type("H", (_Handler,), {"viewer": self})
        self._server = ThreadingHTTPServer((host, port), handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- updates from the SLAM loop ---------------------------------------
    def update(self, frame: Optional[int] = None,
               traj_est: Optional[np.ndarray] = None,
               traj_gt: Optional[np.ndarray] = None,
               frame_points: Optional[np.ndarray] = None,
               submap_boxes: Optional[list] = None,
               mesh: Optional[tuple] = None,
               num_submaps: Optional[int] = None):
        """mesh: (verts (V,3), tris (T,3)) -> decimated wireframe."""
        s = dict(self._state)
        if frame is not None:
            s["frame"] = int(frame)
        if num_submaps is not None:
            s["num_submaps"] = int(num_submaps)
        if traj_est is not None:
            s["traj_est"] = np.asarray(traj_est, np.float32).round(4).tolist()
        if traj_gt is not None:
            s["traj_gt"] = np.asarray(traj_gt, np.float32).round(4).tolist()
        if frame_points is not None:
            p = np.asarray(frame_points, np.float32)
            if len(p) > self.max_frame_points:
                idx = np.random.default_rng(0).choice(
                    len(p), self.max_frame_points, replace=False)
                p = p[idx]
            s["frame_points"] = p.round(3).tolist()
        if submap_boxes is not None:
            s["submap_boxes"] = [np.asarray(b, np.float32).round(3).tolist()
                                 for b in submap_boxes]
        if mesh is not None:
            verts, tris = mesh
            verts = np.asarray(verts, np.float32)
            tris = np.asarray(tris, np.int64)
            edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]])
            if len(edges) > self.max_mesh_edges:
                idx = np.random.default_rng(0).choice(
                    len(edges), self.max_mesh_edges, replace=False)
                edges = edges[idx]
            seg = verts[edges]                       # (E, 2, 3)
            s["mesh_edges"] = seg.round(3).tolist()
        with self._lock:
            self._state = s

    def state_json(self) -> str:
        with self._lock:
            return json.dumps(self._state)

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def submap_box_corners(bound: np.ndarray, R: np.ndarray,
                       t: np.ndarray) -> np.ndarray:
    """(8, 3) world-frame corners of a submap OBB (binary corner order
    matching the viewer's BOX_E edge table)."""
    b = np.asarray(bound, np.float32)
    corners = np.array([[b[0, i], b[1, j], b[2, k]]
                        for i in range(2) for j in range(2) for k in range(2)],
                       np.float32)
    return corners @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
