"""Web viewer: the window + egui GUI replacement for a headless GPU host.

The reference opens a winit window with an egui settings panel
(src/mainloop.rs, src/gui.rs). A GPU server has no display, so the
"window" is a browser page streaming frames over HTTP: a canvas polls
/frame.png, input events post back as JSON, and the settings panel renders
the reflected parameter tree
(editor/params.py describe / set_by_path) — sliders, checkboxes, enum
selects, vec3 fields — exactly the widget set the egui renderer builds
from UiDisplayDescription (src/gui.rs:275-481).

Stdlib-only (http.server); no external web framework.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..editor import events
from ..editor.session import EditorApp
from ..utils import image_io

log = logging.getLogger(__name__)


def _decode_event(d: dict):
    t = d.get("type")
    if t == "cursor":
        return events.CursorMoved(float(d["x"]), float(d["y"]))
    if t == "button":
        return events.MouseInput(events.MouseButton(d["button"]),
                                 bool(d["pressed"]),
                                 float(d.get("x", 0)), float(d.get("y", 0)))
    if t == "delta":
        return events.MouseDelta(float(d["dx"]), float(d["dy"]))
    if t == "key":
        return events.KeyInput(str(d["key"]), bool(d["pressed"]),
                               bool(d.get("ctrl", False)))
    if t == "drop":
        return events.FileDropped(str(d["path"]))
    if t == "resize":
        return events.Resized(int(d["width"]), int(d["height"]))
    return None


class ViewerServer:
    """Serve an EditorApp over HTTP. All engine access is serialized
    through one lock (the single-threaded frame loop the reference has)."""

    def __init__(self, app: EditorApp, host: str = "127.0.0.1",
                 port: int = 8000):
        self.app = app
        self.lock = threading.Lock()
        self._last_time = time.monotonic()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug("viewer: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200) -> None:
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, PAGE_HTML.encode(), "text/html")
                elif path == "/frame.png":
                    self._send(200, outer.render_png(), "image/png")
                elif path == "/state":
                    self._json(outer.state())
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                path = self.path.split("?")[0]
                if path == "/upload":
                    # browser drag&drop: raw file bytes + X-Filename header
                    # (the FileDropped flow of src/player_controller.rs:169-185)
                    try:
                        saved = outer.save_upload(
                            self.headers.get("X-Filename", "dropped.obj"),
                            self.rfile.read(n))
                        self._json({"ok": True, "path": saved})
                    except Exception as e:  # noqa: BLE001
                        with outer.lock:
                            outer.app.engine.notifier.push(str(e), "error")
                        self._json({"error": str(e)}, 500)
                    return
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._json({"error": "bad json"}, 400)
                    return
                try:
                    if path == "/event":
                        outer.post_events(payload)
                        self._json({"ok": True})
                    elif path == "/set":
                        outer.set_param(payload)
                        self._json({"ok": True})
                    elif path == "/action":
                        outer.do_action(payload)
                        self._json({"ok": True})
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # surface as toast, keep serving
                    with outer.lock:
                        outer.app.engine.notifier.push(str(e), "error")
                    self._json({"error": str(e)}, 500)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- request implementations (each takes the lock) -------------------------

    def render_png(self) -> bytes:
        with self.lock:
            now = time.monotonic()
            dt = min(now - self._last_time, 0.1)
            self._last_time = now
            out = self.app.run_frame(dt)
            sdr = out.sdr.cpu().numpy()
        return image_io.encode_png(sdr)

    def state(self) -> dict:
        with self.lock:
            eng = self.app.engine
            return {
                # the host ms of the last run_frame call (the device may
                # still be running the frame), under the reference
                # viewer's key
                "frame_ms": round(eng.last_frame_ms, 3),
                "frame_index": eng.frame_index,
                "selected": self.app.selected_object_id,
                "width": eng.cfg.width,
                "height": eng.cfg.height,
                "toasts": [{"message": t.message, "level": t.level}
                           for t in eng.notifier.active()],
                "params": self.app.registry.describe_all(),
            }

    def post_events(self, payload) -> None:
        evs = payload if isinstance(payload, list) else [payload]
        with self.lock:
            for d in evs:
                ev = _decode_event(d)
                if ev is not None:
                    self.app.handle_event(ev)

    def save_upload(self, filename: str, data: bytes) -> str:
        """Persist a dropped file and raise the FileDropped event — the
        browser-drop analog of winit's DroppedFile (player_controller.rs:169)."""
        import os
        import tempfile

        name = os.path.basename(filename) or "dropped.obj"
        drop_dir = os.path.join(tempfile.gettempdir(), "tinyrenderer_drops")
        os.makedirs(drop_dir, exist_ok=True)
        path = os.path.join(drop_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        with self.lock:
            self.app.handle_event(events.FileDropped(path))
        return path

    def set_param(self, payload: dict) -> None:
        with self.lock:
            self.app.registry.set(payload["name"], payload["path"],
                                  payload["value"])

    def do_action(self, payload: dict) -> None:
        act = payload.get("action")
        with self.lock:
            eng = self.app.engine
            if act == "recompile":
                eng.recompile_kernels()
            elif act == "save_level":
                eng.save_level(payload.get("path", "levels/saved.lvl"))
                eng.notifier.push(f"Saved {payload.get('path', 'levels/saved.lvl')}")
            elif act == "load_level":
                eng.load_level(payload["path"])
            elif act == "save_ibl":
                eng.write_ibl_to_file(payload.get("path", "output_ibl.data"))
                eng.notifier.push("IBL saved")
            elif act == "bake_irradiance":
                from ..render.engine import RenderingAction
                eng.add_action(RenderingAction.BAKE_IRRADIANCE)
            elif act == "set_skybox":
                eng.set_skybox(payload.get("path") or None)
                eng.notifier.push("Environment re-baked")
            elif act == "set_config":
                # switch static pipeline settings (texture_filter, scales,
                # feature toggles, resolution) — recompiles, like swapping
                # pipelines in the reference's cache. Only runtime-tunable
                # fields are accepted, and resolution changes route through
                # engine.resize so the camera projection and pick readback
                # coordinates update atomically (ADVICE r1).
                from dataclasses import replace
                TUNABLE = {"texture_filter", "texture_scale",
                           "shadow_lookup_scale", "sky_scale",
                           "enable_shadows", "enable_ibl", "enable_ssr",
                           "use_pallas", "fused_resolve",
                           "tex_block_capacity", "fwd_tile_capacity",
                           "shadow_size", "forward_only",
                           "render_scale_pct", "windowed_pool",
                           "morton_pool", "shadow_bf16", "bf16_attrs",
                           "stream_raster", "native_texture_pool",
                           "sky_rgbe"}
                values = payload.get("values", {})
                changes = {k: v for k, v in values.items() if k in TUNABLE}
                rejected = set(values) - set(changes) - {"width", "height"}
                if rejected:
                    raise ValueError(f"not runtime-tunable: {sorted(rejected)}")
                preset = payload.get("preset")
                if preset == "performance":
                    eng.cfg = eng.cfg.performance_preset()
                elif preset == "parity":
                    eng.cfg = eng.cfg.reference_parity()
                elif preset is not None:
                    raise ValueError(f"unknown preset {preset!r}")
                if changes:
                    eng.cfg = replace(eng.cfg, **changes)
                if "width" in values or "height" in values:
                    eng.resize(int(values.get("width", eng.cfg.width)),
                               int(values.get("height", eng.cfg.height)))
                    changes["resolution"] = True
                    self.app.controller.width = eng.cfg.width
                    self.app.controller.height = eng.cfg.height
                eng._needs_pack = True
                eng._atlas = None
                eng.notifier.push(f"Config updated: "
                                  f"{', '.join(changes) or preset or ''}"
                                  " (recompiling)")
            else:
                raise ValueError(f"unknown action {act!r}")

    # -- lifecycle -------------------------------------------------------------

    def serve_forever(self) -> None:
        log.info("viewer on http://%s:%d/", *self.httpd.server_address)
        self.httpd.serve_forever()

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


PAGE_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tinyrenderer_tpu</title>
<style>
 body{margin:0;display:flex;font-family:system-ui,sans-serif;background:#16161a;color:#ddd}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 canvas{max-width:100%;max-height:100vh;outline:none}
 #panel{width:330px;max-height:100vh;overflow-y:auto;padding:10px;background:#222228;font-size:13px}
 #panel h3{margin:8px 0 4px}
 .row{display:flex;align-items:center;gap:6px;margin:2px 0 2px 10px}
 .row label{flex:0 0 42%;overflow:hidden;text-overflow:ellipsis;white-space:nowrap}
 input[type=range]{flex:1}
 input[type=number]{width:60px;background:#333;color:#ddd;border:1px solid #555}
 select,button{background:#333;color:#ddd;border:1px solid #555;margin:2px}
 #toasts{position:fixed;right:340px;top:8px}
 .toast{padding:6px 10px;margin:4px;border-radius:4px;background:#334}
 .toast.error{background:#833}
 #hud{position:fixed;left:8px;top:8px;font-size:12px;color:#9f9}
</style></head><body>
<div id="view"><canvas id="c" tabindex="0"></canvas></div>
<div id="panel">
 <h2>Settings page</h2>
 <div>
  <button onclick="act('recompile')">Recompile shaders</button>
  <button onclick="act('save_level')">Save level</button>
  <button onclick="act('bake_irradiance')">Bake IBL</button>
  <button onclick="act('save_ibl')">Save IBL</button>
  <button onclick="fetch('/action',{method:'POST',body:JSON.stringify({action:'set_config',preset:'performance'})})">Fast preset</button>
  <button onclick="fetch('/action',{method:'POST',body:JSON.stringify({action:'set_config',preset:'parity'})})">Parity preset</button>
  <div class="row"><label>Spawn model (path)</label>
   <input type="text" id="spawnpath" placeholder="assets/models/cube/cube.obj">
   <button onclick="send({type:'drop', path:document.getElementById('spawnpath').value})">Add</button></div>
  <div class="row"><label>Drop a .obj on the canvas to spawn it</label></div>
  <select onchange="fetch('/action',{method:'POST',body:JSON.stringify({action:'set_config',values:{render_scale_pct:parseInt(this.value)}})})">
    <option value="100">100% scale</option>
    <option value="75">75% scale</option>
    <option value="50">50% scale</option>
  </select>
  <select onchange="fetch('/action',{method:'POST',body:JSON.stringify({action:'set_config',values:{texture_filter:this.value}})})">
    <option value="dithered">dithered</option><option value="trilinear">trilinear</option>
    <option value="bilinear">bilinear</option><option value="stochastic">stochastic</option>
  </select>
  <select id="res" onchange="const [w,h]=this.value.split('x').map(Number);
    fetch('/action',{method:'POST',body:JSON.stringify({action:'set_config',values:{width:w,height:h}})})">
    <option value="">resolution...</option>
    <option>640x360</option><option>800x600</option><option>1280x720</option>
    <option>1920x1080</option><option>2560x1440</option>
  </select>
 </div>
 <div id="params"></div>
</div>
<div id="toasts"></div><div id="hud"></div>
<script>
const c = document.getElementById('c'), ctx2 = c.getContext('2d');
const img = new Image();
let queue = [];
function send(ev){ queue.push(ev); }
async function flushEvents(){
  if (queue.length){ const q = queue; queue = [];
    await fetch('/event', {method:'POST', body: JSON.stringify(q)}); }
}
function canvasXY(e){
  const r = c.getBoundingClientRect();
  return {x:(e.clientX-r.left)*c.width/r.width, y:(e.clientY-r.top)*c.height/r.height};
}
c.addEventListener('mousemove', e=>{
  const p = canvasXY(e); send({type:'cursor', x:p.x, y:p.y});
  if (e.buttons & 2) send({type:'delta', dx:e.movementX, dy:e.movementY});
});
const btn = b => b===0?'left':(b===2?'right':'middle');
c.addEventListener('mousedown', e=>{const p=canvasXY(e);
  send({type:'button', button:btn(e.button), pressed:true, x:p.x, y:p.y}); c.focus();});
c.addEventListener('mouseup', e=>{const p=canvasXY(e);
  send({type:'button', button:btn(e.button), pressed:false, x:p.x, y:p.y});});
c.addEventListener('contextmenu', e=>e.preventDefault());
// HTML5 drag&drop: upload the file, server raises FileDropped -> spawn
// (winit DroppedFile analog, src/player_controller.rs:169-185)
c.addEventListener('dragover', e=>e.preventDefault());
document.body.addEventListener('dragover', e=>e.preventDefault());
document.body.addEventListener('drop', async e=>{
  e.preventDefault();
  for (const f of e.dataTransfer.files){
    await fetch('/upload', {method:'POST', headers:{'X-Filename': f.name},
                            body: f});
  }
});
c.addEventListener('keydown', e=>{ if(!e.repeat) send({type:'key', key:e.key, pressed:true, ctrl:e.ctrlKey}); e.preventDefault();});
c.addEventListener('keyup', e=>{ send({type:'key', key:e.key, pressed:false, ctrl:e.ctrlKey}); e.preventDefault();});

async function frameLoop(){
  for(;;){
    await flushEvents();
    const t0 = performance.now();
    try {
      const blob = await (await fetch('/frame.png?t='+Date.now())).blob();
      const bmp = await createImageBitmap(blob);
      if (c.width !== bmp.width){ c.width = bmp.width; c.height = bmp.height; }
      ctx2.drawImage(bmp, 0, 0);
    } catch(e) {}
    const dt = performance.now() - t0;
    document.getElementById('hud').textContent =
      'round-trip ' + dt.toFixed(1) + ' ms  |  engine ' + (window._fms||'?') + ' ms';
    await new Promise(r=>setTimeout(r, Math.max(0, 33 - dt)));
  }
}
function widget(name, node, path){
  const d = document.createElement('div');
  if (!node) return d;
  const p = JSON.stringify(path);
  if (node.kind === 'struct'){
    const h = document.createElement('h3'); h.textContent = node.name || name;
    d.appendChild(h);
    for (const f of node.fields) d.appendChild(widget(name, f, path.concat([f.name])));
  } else if (node.kind === 'vector'){
    const h = document.createElement('h3'); h.textContent = node.name;
    d.appendChild(h);
    node.items.forEach((it,i)=>d.appendChild(widget(name, it, path.concat([i]))));
  } else if (node.kind === 'slider_float' || node.kind === 'slider_int'){
    d.className='row';
    d.innerHTML = `<label>${node.name}</label>
      <input type="range" min="${node.min}" max="${node.max}"
        step="${node.kind==='slider_int'?1:(node.max-node.min)/200}" value="${node.value}">
      <input type="number" value="${node.value}">`;
    const [rng, num] = d.querySelectorAll('input');
    const go = v => setParam(name, path, node.kind==='slider_int'?parseInt(v):parseFloat(v));
    rng.oninput = ()=>{ num.value = rng.value; go(rng.value); };
    num.onchange = ()=>{ rng.value = num.value; go(num.value); };
  } else if (node.kind === 'bool'){
    d.className='row';
    d.innerHTML = `<label>${node.name}</label><input type="checkbox" ${node.value?'checked':''}>`;
    d.querySelector('input').onchange = e=>setParam(name, path, e.target.checked);
  } else if (node.kind === 'enum'){
    d.className='row';
    d.innerHTML = `<label>${node.name}</label><select>` +
      node.variants.map(v=>`<option ${v===node.value?'selected':''}>${v}</option>`).join('') +
      '</select>';
    d.querySelector('select').onchange = e=>setParam(name, path, e.target.value);
  } else if (node.kind === 'vec3' || node.kind === 'rotation'){
    d.className='row';
    d.innerHTML = `<label>${node.name}</label>` +
      node.value.map((v,i)=>`<input type="number" step="0.1" value="${v.toFixed(3)}">`).join('');
    d.querySelectorAll('input').forEach((inp,i)=>{
      inp.onchange = ()=>setParam(name, path.concat([i]), parseFloat(inp.value));
    });
  } else if (node.kind === 'path'){
    d.className='row';
    d.innerHTML = `<label>${node.name}</label><input type="text" value="${node.value}">`;
    d.querySelector('input').onchange = e=>setParam(name, path, e.target.value);
  }
  return d;
}
async function setParam(name, path, value){
  await fetch('/set', {method:'POST', body: JSON.stringify({name, path, value})});
  paramsDirty = true;
}
let paramsDirty = true, lastParamsJson = '';
async function stateLoop(){
  for(;;){
    try {
      const s = await (await fetch('/state')).json();
      window._fms = s.frame_ms;
      document.getElementById('toasts').innerHTML =
        s.toasts.map(t=>`<div class="toast ${t.level}">${t.message}</div>`).join('');
      const pj = JSON.stringify(Object.keys(s.params)) + (s.selected||'');
      if (paramsDirty || pj !== lastParamsJson){
        lastParamsJson = pj; paramsDirty = false;
        const host = document.getElementById('params'); host.innerHTML='';
        for (const [name, tree] of Object.entries(s.params))
          host.appendChild(widget(name, tree, []));
      }
    } catch(e) {}
    await new Promise(r=>setTimeout(r, 500));
  }
}
frameLoop(); stateLoop();
</script></body></html>
"""
