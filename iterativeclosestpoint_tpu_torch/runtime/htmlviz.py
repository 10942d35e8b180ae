"""Interactive 3-D viewer export (C8 PointCloudViewer, interactive form).

The reference's viewer is a QOpenGLWidget with an orbit/pan/zoom camera
and per-iteration replay (widgets/pointcloudviewer.cpp:341-412 camera,
:86-116 replay; stepped from the VisualizationPage slider,
ui/pages/visualizationpage.cpp:124-150). The framework equivalent is a
single self-contained HTML file: raw WebGL1 point rendering (no external
libraries, works offline), the same camera gestures (drag = orbit,
shift/right-drag = pan, wheel = zoom, F = fit-to-scene,
pointcloudviewer.cpp:164-210), and an iteration slider + prev/next/play
that re-applies ``history[k].transform`` to the embedded ORIGINAL source
cloud — replay is a pure function of the history, exactly like
``session.replay(k)``; the GPU re-applies the 4x4 on every frame so
stepping costs nothing.

Two exports share the machinery:
  - ``export_interactive_html``: source vs target + iteration replay
    (the pairwise registration view).
  - ``export_scene_html``: N named clouds with per-cloud colors and
    visibility toggles (the multi-scan ``icp graph`` result view).

Coordinates are embedded as base64 float32 *centered* on the combined
bbox center (UTM-scale absolute coordinates do not survive f32); the
per-iteration transforms are re-based to the centered frame on the host:
``t_c = R @ c + t - c``.

The port's own copy of the JAX package's ``runtime/htmlviz.py``: the same
inputs give the same bytes.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# Color cycle for multi-scan scenes (index 0/1 match the pairwise
# source-red / target-blue convention).
_PALETTE = [
    (1.00, 0.42, 0.33),
    (0.36, 0.61, 1.00),
    (0.45, 0.85, 0.45),
    (0.95, 0.75, 0.25),
    (0.80, 0.50, 0.95),
    (0.40, 0.85, 0.85),
    (0.95, 0.55, 0.75),
    (0.75, 0.75, 0.55),
]


def _pack_points(pts: np.ndarray, max_points: int, seed: int = 0) -> np.ndarray:
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) > max_points:
        idx = np.random.default_rng(seed).choice(len(pts), max_points, False)
        idx.sort()  # keep spatial scan order (compresses better, stable)
        pts = pts[idx]
    return pts


def _b64_f32(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a, dtype="<f4").tobytes()
    ).decode("ascii")


def _write_scene(
    path: str | Path,
    clouds: Sequence[tuple],  # (name, points_subsampled, total_count, color)
    history: Optional[Sequence[dict]],
    title: str,
    refresh_s: float = 0.0,
) -> None:
    all_pts = [c[1] for c in clouds]
    lo = np.min([p.min(axis=0) for p in all_pts], axis=0)
    hi = np.max([p.max(axis=0) for p in all_pts], axis=0)
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(hi - lo) / 2.0) or 1.0

    transforms = []
    stats = []
    for rec in history or []:
        T = np.asarray(rec["transform"], dtype=np.float64)
        R, t = T[:3, :3], T[:3, 3]
        tc = R @ center + t - center  # re-base to the centered frame
        Tc = np.eye(4)
        Tc[:3, :3], Tc[:3, 3] = R, tc
        transforms.append(Tc.tolist())
        stats.append({
            k: rec[k]
            for k in ("iteration", "rmse", "valid_points", "outlier_points",
                      "rotation_angle_deg", "translation_norm")
            if k in rec
        })

    payload = {
        "title": title,
        "radius": radius,
        "zLow": float(lo[2] - center[2]),
        "clouds": [
            {
                "name": name,
                "n": int(len(pts)),
                "total": int(total),
                "color": list(color),
                # replay transforms apply to cloud 0 (the moving source)
                "replay": i == 0 and bool(transforms),
                "pts": _b64_f32(pts - center),
            }
            for i, (name, pts, total, color) in enumerate(clouds)
        ],
        "transforms": transforms,
        "stats": stats,
    }
    # "</" must not appear inside the inline <script> (e.g. a title
    # containing "</script>" would truncate the document).
    blob = json.dumps(payload).replace("</", "<\\/")
    html = _TEMPLATE.replace("/*__DATA__*/null", blob)
    if refresh_s > 0:
        html = html.replace(
            "<html><head><meta charset=\"utf-8\">",
            "<html><head><meta charset=\"utf-8\">"
            f"<meta http-equiv=\"refresh\" content=\"{refresh_s:g}\">",
        )
    # Atomic replace: a live viewer reloading mid-write must never see a
    # truncated document.
    tmp = Path(str(path) + ".tmp")
    tmp.write_text(html)
    tmp.replace(Path(path))


def export_interactive_html(
    path: str | Path,
    source: np.ndarray,
    target: np.ndarray,
    history: Optional[Sequence[dict]] = None,
    title: str = "",
    max_points: int = 400_000,
    refresh_s: float = 0.0,
) -> None:
    """Write a standalone pairwise-registration viewer.

    ``source`` must be the ORIGINAL (un-registered) source cloud when a
    ``history`` is given — the replay applies cumulative transforms to it
    (pointcloudviewer.cpp:96 restores the original before re-applying).
    ``history``: list of per-iteration records with at least
    ``transform`` (4,4); ``rmse``/``valid_points``/``outlier_points``
    are shown in the HUD when present.

    ``refresh_s`` > 0 marks the export as LIVE: the page auto-reloads
    every that many seconds (mid-run segment-boundary exports — the
    reference GUI's during-run viewer updates, mainwindow.cpp:115-123);
    the final export rewrites the file without it.
    """
    src = _pack_points(source, max_points, seed=0)
    tgt = _pack_points(target, max_points, seed=1)
    _write_scene(
        path,
        [("source", src, len(np.asarray(source)), _PALETTE[0]),
         ("target", tgt, len(np.asarray(target)), _PALETTE[1])],
        history,
        title,
        refresh_s=refresh_s,
    )


def export_scene_html(
    path: str | Path,
    clouds: Sequence[np.ndarray],
    names: Optional[Sequence[str]] = None,
    title: str = "",
    max_points: int = 200_000,
) -> None:
    """Write a standalone multi-cloud scene viewer (no replay): each
    cloud gets a palette color and a HUD visibility toggle — the
    ``icp graph`` result view (scans in their optimized poses)."""
    if not clouds:
        raise ValueError("no clouds to export")
    names = list(names) if names else [f"scan {i}" for i in range(len(clouds))]
    packed = [
        (names[i], _pack_points(c, max_points, seed=i), len(np.asarray(c)),
         _PALETTE[i % len(_PALETTE)])
        for i, c in enumerate(clouds)
    ]
    _write_scene(path, packed, None, title)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>icp viewer</title>
<style>
  html,body{margin:0;height:100%;overflow:hidden;background:#101216;
            font:13px/1.4 system-ui,sans-serif;color:#cfd4dc}
  #c{width:100%;height:100%;display:block;cursor:grab}
  #hud{position:fixed;left:10px;top:10px;background:rgba(16,18,22,.82);
       border:1px solid #2a2e36;border-radius:8px;padding:10px 12px;
       max-width:380px}
  #hud b{color:#fff}
  .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
      margin-right:6px;vertical-align:-1px}
  .cl{cursor:pointer;user-select:none}
  .cl.off{opacity:.35}
  #bar{position:fixed;left:50%;transform:translateX(-50%);bottom:12px;
       background:rgba(16,18,22,.82);border:1px solid #2a2e36;
       border-radius:8px;padding:8px 14px;display:flex;gap:10px;
       align-items:center;white-space:nowrap}
  button{background:#232832;color:#cfd4dc;border:1px solid #3a4150;
         border-radius:5px;padding:2px 10px;cursor:pointer}
  button:hover{background:#2e3542}
  input[type=range]{width:260px}
  #help{position:fixed;right:10px;top:10px;background:rgba(16,18,22,.82);
        border:1px solid #2a2e36;border-radius:8px;padding:8px 12px;
        color:#8b93a1}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="help">drag&nbsp;orbit · shift/right-drag&nbsp;pan ·
wheel&nbsp;zoom · F&nbsp;fit · G&nbsp;grid · click&nbsp;name&nbsp;to&nbsp;toggle</div>
<div id="bar" style="display:none">
  <button id="prev">&#9664;</button>
  <input type="range" id="slider" min="0" value="0" step="1">
  <button id="next">&#9654;</button>
  <button id="play">&#9654;&#9654;</button>
  <span id="iterlab"></span>
</div>
<script>
"use strict";
const D=/*__DATA__*/null;
const f32=b64=>{const s=atob(b64),u=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);
  return new Float32Array(u.buffer);};
const K=D.transforms.length;

const cv=document.getElementById("c");
const gl=cv.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;uniform mat4 M,V,P;uniform float ps;
void main(){gl_Position=P*V*M*vec4(p,1.0);gl_PointSize=ps;}`;
const FS=`precision mediump float;uniform vec4 col;uniform float uPt;
void main(){if(uPt>0.5){vec2 d=gl_PointCoord-vec2(.5);
if(dot(d,d)>.25)discard;}gl_FragColor=col;}`;
function prog(vs,fs){const c=(t,s)=>{const h=gl.createShader(t);
  gl.shaderSource(h,s);gl.compileShader(h);
  if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(h);return h;};
  const p=gl.createProgram();gl.attachShader(p,c(gl.VERTEX_SHADER,vs));
  gl.attachShader(p,c(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const pr=prog(VS,FS);
const loc={p:gl.getAttribLocation(pr,"p"),M:gl.getUniformLocation(pr,"M"),
  V:gl.getUniformLocation(pr,"V"),P:gl.getUniformLocation(pr,"P"),
  ps:gl.getUniformLocation(pr,"ps"),col:gl.getUniformLocation(pr,"col"),
  uPt:gl.getUniformLocation(pr,"uPt")};
function buf(a){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,a,gl.STATIC_DRAW);return b;}
const clouds=D.clouds.map(c=>({...c,buf:buf(f32(c.pts)),on:true}));

// grid + axes (pointcloudviewer.cpp draws a ground grid and XYZ axes)
const grid=[];{const r=D.radius,n=10,s=r/n,z=D.zLow;
  for(let i=-n;i<=n;i++){grid.push(-r,i*s,z, r,i*s,z, i*s,-r,z, i*s,r,z);}}
const gridBuf=buf(new Float32Array(grid)),gridN=grid.length/3;
const ax=D.radius*0.5,axes=[[ax,0,0,[1,.3,.3]],[0,ax,0,[.3,1,.3]],
  [0,0,ax,[.4,.6,1]]];
const axBufs=axes.map(a=>buf(new Float32Array([0,0,0,a[0],a[1],a[2]])));

// ---- matrices ----
const I4=[1,0,0,0,0,1,0,0,0,0,1,0,0,0,0,1];
function persp(fov,asp,n,f){const t=1/Math.tan(fov/2);
  return[t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1, 0,0,2*f*n/(n-f),0];}
// camera: yaw/pitch orbit about focus at distance d (viewer.cpp:341-358)
const cam={yaw:-0.7,pitch:0.5,dist:D.radius*2.2,focus:[0,0,0]};
function view(){const cy=Math.cos(cam.yaw),sy=Math.sin(cam.yaw),
  cp=Math.cos(cam.pitch),sp=Math.sin(cam.pitch);
  // z-up world: eye = focus + d*(cy*cp, sy*cp, sp)
  const e=[cam.focus[0]+cam.dist*cy*cp,cam.focus[1]+cam.dist*sy*cp,
           cam.focus[2]+cam.dist*sp];
  const f=norm3(sub3(cam.focus,e)),r=norm3(cross(f,[0,0,1])),
        u=cross(r,f);
  return[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
    -dot3(r,e),-dot3(u,e),dot3(f,e),1];}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
  return[a[0]/l,a[1]/l,a[2]/l];}
// row-major numpy 4x4 -> column-major GL
function colMajor(T){const o=new Array(16);
  for(let r=0;r<4;r++)for(let c=0;c<4;c++)o[c*4+r]=T[r][c];return o;}
const models=[I4].concat(D.transforms.map(colMajor));

let iter=K,showGrid=true;
function draw(){
  const w=cv.clientWidth,h=cv.clientHeight;
  if(cv.width!==w*devicePixelRatio||cv.height!==h*devicePixelRatio){
    cv.width=w*devicePixelRatio;cv.height=h*devicePixelRatio;}
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(0.063,0.071,0.086,1);gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.useProgram(pr);
  gl.uniformMatrix4fv(loc.P,false,new Float32Array(
    persp(0.9,w/h,D.radius*1e-3,D.radius*40)));
  gl.uniformMatrix4fv(loc.V,false,new Float32Array(view()));
  gl.enableVertexAttribArray(loc.p);
  const lines=(b,n,c)=>{gl.bindBuffer(gl.ARRAY_BUFFER,b);
    gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,0,0);
    gl.uniformMatrix4fv(loc.M,false,new Float32Array(I4));
    gl.uniform1f(loc.uPt,0);
    gl.uniform4fv(loc.col,c);gl.drawArrays(gl.LINES,0,n);};
  if(showGrid){lines(gridBuf,gridN,[0.17,0.19,0.23,1]);
    for(let i=0;i<3;i++)lines(axBufs[i],2,axes[i][3].concat([1]));}
  for(const c of clouds){
    if(!c.on)continue;
    gl.bindBuffer(gl.ARRAY_BUFFER,c.buf);
    gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,0,0);
    gl.uniformMatrix4fv(loc.M,false,
      new Float32Array(c.replay?models[iter]:I4));
    gl.uniform4fv(loc.col,c.color.concat([1]));
    gl.uniform1f(loc.ps,2.0*devicePixelRatio);
    gl.uniform1f(loc.uPt,1);
    gl.drawArrays(gl.POINTS,0,c.n);
  }
}
function esc(x){return String(x).replace(/&/g,"&amp;").replace(/</g,"&lt;")
  .replace(/>/g,"&gt;").replace(/"/g,"&quot;");}
function hud(){const s=D.stats[iter-1];
  let t=`<b>${esc(D.title||"icp viewer")}</b><br>`;
  for(let i=0;i<clouds.length;i++){const c=clouds[i];
    const rgb=`rgb(${c.color.map(x=>Math.round(x*255)).join(",")})`;
    t+=`<span class="cl${c.on?"":" off"}" data-i="${i}">`+
       `<span class="sw" style="background:${rgb}"></span>`+
       `${esc(c.name)} ${c.total.toLocaleString()} pts`+
       (c.n<c.total?` (showing ${c.n.toLocaleString()})`:"")+`</span><br>`;}
  if(K){t+=iter===0?`iteration 0 / ${K} (original source)`:
    `iteration ${iter} / ${K}`;
    if(s){if("rmse"in s)t+=` · RMSE ${Number(s.rmse).toPrecision(6)}`;
      if("valid_points"in s)t+=`<br>${s.valid_points.toLocaleString()} valid`+
        (("outlier_points"in s)?` · ${s.outlier_points.toLocaleString()} outliers`:"");
      if("rotation_angle_deg"in s)t+=`<br>rot ${Number(s.rotation_angle_deg).toFixed(4)}° · `+
        `|t| ${Number(s.translation_norm).toFixed(4)} m`;}}
  const el=document.getElementById("hud");
  el.innerHTML=t;
  el.querySelectorAll(".cl").forEach(n=>{n.onclick=()=>{
    const c=clouds[+n.dataset.i];c.on=!c.on;hud();draw();};});}
function setIter(k){iter=Math.max(0,Math.min(K,k));
  slider.value=iter;iterlab.textContent=`${iter}/${K}`;hud();draw();}

// ---- interaction (viewer.cpp:360-412 gestures) ----
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
  pan:e.button===2||e.shiftKey};cv.style.cursor="grabbing";});
addEventListener("mouseup",()=>{drag=null;cv.style.cursor="grab";});
addEventListener("mousemove",e=>{if(!drag)return;
  const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
  drag.x=e.clientX;drag.y=e.clientY;
  if(drag.pan){const s=cam.dist*0.0012,cy=Math.cos(cam.yaw),
    sy=Math.sin(cam.yaw);
    cam.focus[0]+=s*(sy*dx);cam.focus[1]+=s*(-cy*dx);
    cam.focus[2]+=s*dy;}
  else{cam.yaw-=dx*0.008;
    cam.pitch=Math.max(-1.55,Math.min(1.55,cam.pitch+dy*0.008));}
  draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
  cam.dist*=Math.pow(1.0015,e.deltaY);
  cam.dist=Math.max(D.radius*0.01,Math.min(D.radius*30,cam.dist));
  draw();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());
addEventListener("keydown",e=>{
  if(e.key==="f"||e.key==="F"){cam.focus=[0,0,0];
    cam.dist=D.radius*2.2;draw();}
  if(e.key==="g"||e.key==="G"){showGrid=!showGrid;draw();}
  // When the slider has focus its native arrow handling already steps
  // the iteration (via oninput); skip ours or each press steps twice.
  if(document.activeElement===slider)return;
  if(e.key==="ArrowLeft")setIter(iter-1);
  if(e.key==="ArrowRight")setIter(iter+1);});
addEventListener("resize",draw);

// ---- replay controls (visualizationpage.cpp:124-150) ----
const bar=document.getElementById("bar"),
  slider=document.getElementById("slider"),
  iterlab=document.getElementById("iterlab");
let playing=null;
if(K){bar.style.display="flex";slider.max=K;slider.value=K;
  slider.oninput=()=>setIter(+slider.value);
  document.getElementById("prev").onclick=()=>setIter(iter-1);
  document.getElementById("next").onclick=()=>setIter(iter+1);
  document.getElementById("play").onclick=function(){
    if(playing){clearInterval(playing);playing=null;
      this.innerHTML="&#9654;&#9654;";return;}
    this.innerHTML="&#10074;&#10074;";setIter(0);
    playing=setInterval(()=>{if(iter>=K){clearInterval(playing);
      playing=null;document.getElementById("play").innerHTML="&#9654;&#9654;";
      return;}setIter(iter+1);},400);};}
setIter(K);
</script></body></html>
"""
