"""Shared WebGL renderer core of the HTML viewers (a copy of the JAX
package's ``viz/webgl_core.py``; the strings are byte-equal).

One hand-written renderer serves both browser surfaces: the self-contained
offline export (``viz/html_export.py``) and the live polling viewer page
(``viz/live_server.py``), the headless counterparts of Open3D's offline
and live ``VisualizerWithKeyCallback`` windows.

``CORE_JS`` defines ``makeViewer(canvas, hud, title)`` returning a handle with

- ``setGeometry(name, meta, pos, col, nrm, idx)`` — create/replace one named
  object (meta.mode: 0 points, 1 indexed triangles, 2 triangle soup); buffers
  are DYNAMIC_DRAW so live pages can restream them every update;
- ``removeGeometry(name)``, ``resetView()``, ``setStatus(text)`` — extra HUD
  line (the live page shows frame/fps telemetry there);
- ``localKeys(set)`` — keys the page should NOT handle locally (the live page
  forwards the reconstruction key map — S save, C reset, M mesh... — to the
  host process instead; view keys R/P/N/L stay local).

The render loop bumps ``window.__frames`` every frame as a liveness hook for
browser-driven checks.
"""

CORE_JS = r"""
"use strict";
function makeViewer(canvas, hud, title) {
  const gl = canvas.getContext("webgl");
  if (!gl) { hud.textContent = "WebGL unavailable"; return null; }
  const extIdx = gl.getExtension("OES_element_index_uint");

  const VS = `
  attribute vec3 aPos; attribute vec3 aCol; attribute vec3 aNrm;
  uniform mat4 uMVP; uniform mat3 uRot; uniform float uPointSize;
  varying vec3 vCol; varying vec3 vNrm;
  void main() {
    gl_Position = uMVP * vec4(aPos, 1.0);
    gl_PointSize = uPointSize;
    vCol = aCol; vNrm = uRot * aNrm;
  }`;
  const FS = `
  precision mediump float;
  varying vec3 vCol; varying vec3 vNrm;
  uniform float uShaded; uniform float uNormalViz;
  void main() {
    // zero-filled normals (clouds without normals) must not normalize():
    // NaN would poison the mix() chain even at weight 0 under IEEE rules
    vec3 n = dot(vNrm, vNrm) > 0.0 ? normalize(vNrm) : vec3(0.0, 0.0, 1.0);
    float lam = 0.35 + 0.65 * abs(n.z);           // headlight Lambert
    vec3 shaded = mix(vCol, vCol * lam, uShaded);
    vec3 nviz = 0.5 * n + 0.5;
    gl_FragColor = vec4(mix(shaded, nviz, uNormalViz), 1.0);
  }`;

  function shader(type, src) {
    const s = gl.createShader(type);
    gl.shaderSource(s, src); gl.compileShader(s);
    if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
      throw gl.getShaderInfoLog(s);
    return s;
  }
  const prog = gl.createProgram();
  gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
  gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
  gl.linkProgram(prog); gl.useProgram(prog);

  const loc = {
    aPos: gl.getAttribLocation(prog, "aPos"),
    aCol: gl.getAttribLocation(prog, "aCol"),
    aNrm: gl.getAttribLocation(prog, "aNrm"),
    uMVP: gl.getUniformLocation(prog, "uMVP"),
    uRot: gl.getUniformLocation(prog, "uRot"),
    uShaded: gl.getUniformLocation(prog, "uShaded"),
    uNormalViz: gl.getUniformLocation(prog, "uNormalViz"),
    uPointSize: gl.getUniformLocation(prog, "uPointSize"),
  };

  const objs = new Map();   // name -> {meta, bufs, idxBuf, hasNrm}
  let C = [0, 0, 0], R = 1e-6;
  let theta = 0.5, phi = 0.9, dist = 2.5 * R, panX = 0, panY = 0;
  let points = false, shaded = true, normalViz = false;
  let haveView = false, status = "";
  let local = null;         // keys handled by the page (null = all)

  function resetView() {
    theta = 0.5; phi = 0.9; dist = 2.5 * R; panX = panY = 0;
  }
  function refit() {
    // union bounds over all objects
    let lo = [1e30, 1e30, 1e30], hi = [-1e30, -1e30, -1e30], any = false;
    for (const o of objs.values()) {
      if (!o.meta.n_vertices) continue;
      any = true;
      for (let k = 0; k < 3; k++) {
        lo[k] = Math.min(lo[k], o.meta.center[k] - o.meta.radius);
        hi[k] = Math.max(hi[k], o.meta.center[k] + o.meta.radius);
      }
    }
    if (!any) return;
    C = [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, (lo[2] + hi[2]) / 2];
    R = Math.max(1e-6, Math.hypot(hi[0] - lo[0], hi[1] - lo[1],
                                  hi[2] - lo[2]) / 2);
    if (!haveView) { resetView(); haveView = true; }
  }
  function upload(buf, data) {
    gl.bindBuffer(gl.ARRAY_BUFFER, buf);
    gl.bufferData(gl.ARRAY_BUFFER, data, gl.DYNAMIC_DRAW);
  }
  function setGeometry(name, meta, pos, col, nrm, idx) {
    let o = objs.get(name);
    if (!o) {
      o = { bufs: { pos: gl.createBuffer(), col: gl.createBuffer(),
                    nrm: gl.createBuffer() },
            idxBuf: gl.createBuffer() };
      objs.set(name, o);
    }
    o.meta = meta;
    o.hasNrm = !!nrm;
    upload(o.bufs.pos, pos);
    upload(o.bufs.col, col || new Uint8Array(pos.length).fill(180));
    upload(o.bufs.nrm, nrm || new Float32Array(pos.length).fill(0));
    if (idx && idx.length && extIdx) {
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, o.idxBuf);
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, idx, gl.DYNAMIC_DRAW);
    }
    refit();
  }
  function removeGeometry(name) { objs.delete(name); refit(); }

  function mat4mul(a, b) {
    const o = new Float32Array(16);
    for (let r = 0; r < 4; r++) for (let c = 0; c < 4; c++) {
      let s = 0;
      for (let k = 0; k < 4; k++) s += a[k * 4 + r] * b[c * 4 + k];
      o[c * 4 + r] = s;
    }
    return o;
  }

  function draw() {
    const w = canvas.clientWidth, h = canvas.clientHeight;
    if (canvas.width !== w || canvas.height !== h) {
      canvas.width = w; canvas.height = h; gl.viewport(0, 0, w, h);
    }
    const ct = Math.cos(theta), st = Math.sin(theta);
    const cp = Math.cos(phi), sp = Math.sin(phi);
    // column-major view rotation (world -> eye)
    const rot = [ct, st * cp, st * sp, 0,
                 -st, ct * cp, ct * sp, 0,
                 0, -sp, cp, 0,
                 0, 0, 0, 1];
    const trans = [1,0,0,0, 0,1,0,0, 0,0,1,0, -C[0], -C[1], -C[2], 1];
    let mv = mat4mul(rot, trans);
    mv[12] += panX; mv[13] += panY; mv[14] -= dist;
    const f = 1.0 / Math.tan(0.4), aspect = w / Math.max(h, 1);
    const zn = 0.01 * R, zf = 100 * R;
    const proj = [f / aspect, 0, 0, 0,  0, f, 0, 0,
                  0, 0, (zf + zn) / (zn - zf), -1,
                  0, 0, 2 * zf * zn / (zn - zf), 0];
    gl.uniformMatrix4fv(loc.uMVP, false, mat4mul(proj, mv));
    gl.uniformMatrix3fv(loc.uRot, false,
      [rot[0], rot[1], rot[2], rot[4], rot[5], rot[6], rot[8], rot[9], rot[10]]);
    gl.uniform1f(loc.uNormalViz, normalViz ? 1.0 : 0.0);
    gl.uniform1f(loc.uPointSize, 2.0);
    gl.enable(gl.DEPTH_TEST);
    gl.clearColor(0.063, 0.078, 0.094, 1);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);

    let nv = 0, nt = 0;
    for (const o of objs.values()) {
      const m = o.meta;
      if (!m.n_vertices) continue;
      nv += m.n_vertices;
      function attrib(name, ncomp, type, normalize) {
        gl.bindBuffer(gl.ARRAY_BUFFER, o.bufs[name.slice(1).toLowerCase()]);
        gl.enableVertexAttribArray(loc[name]);
        gl.vertexAttribPointer(loc[name], ncomp, type, normalize, 0, 0);
      }
      attrib("aPos", 3, gl.FLOAT, false);
      attrib("aCol", 3, gl.UNSIGNED_BYTE, true);
      attrib("aNrm", 3, gl.FLOAT, false);
      const asPoints = points || m.mode === 0;
      gl.uniform1f(loc.uShaded, shaded && !asPoints && o.hasNrm ? 1.0 : 0.0);
      if (!asPoints && m.mode === 1 && extIdx) {
        nt += m.n_indices / 3;
        gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, o.idxBuf);
        gl.drawElements(gl.TRIANGLES, m.n_indices, gl.UNSIGNED_INT, 0);
      } else if (!asPoints && m.mode === 2) {
        nt += m.n_vertices / 3;
        gl.drawArrays(gl.TRIANGLES, 0, m.n_vertices);
      } else {
        gl.drawArrays(gl.POINTS, 0, m.n_vertices);
      }
    }
    hud.textContent =
      title + "\n" +
      (nv ? nv.toLocaleString() + " vertices" +
            (nt ? ", " + Math.round(nt).toLocaleString() + " triangles" : "")
          : "(no geometry yet)") +
      (status ? "\n" + status : "") +
      "\ndrag rotate | wheel zoom | shift-drag pan | R reset view | " +
      "P points | N normals | L light";
    window.__frames = (window.__frames || 0) + 1;   // test/liveness hook
  }
  function loop() { draw(); requestAnimationFrame(loop); }

  let drag = null;
  canvas.addEventListener("mousedown",
    e => { drag = [e.clientX, e.clientY, e.shiftKey || e.button === 2]; });
  window.addEventListener("mouseup", () => { drag = null; });
  window.addEventListener("mousemove", e => {
    if (!drag) return;
    const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
    if (drag[2]) { panX += dx * 0.002 * dist; panY -= dy * 0.002 * dist; }
    else {
      theta -= dx * 0.006;
      phi = Math.min(3.1, Math.max(0.05, phi - dy * 0.006));
    }
    drag[0] = e.clientX; drag[1] = e.clientY;
  });
  canvas.addEventListener("wheel", e => {
    dist *= Math.exp(e.deltaY * 0.001);
    dist = Math.min(50 * R, Math.max(0.05 * R, dist));
    e.preventDefault();
  }, { passive: false });
  canvas.addEventListener("contextmenu", e => e.preventDefault());
  const handle = {
    setGeometry, removeGeometry, resetView,
    setStatus: t => { status = t; },
    localKeys: null,        // set by the live page: keys the HOST owns
    onHostKey: null,        // live page callback for forwarded keys
  };
  window.addEventListener("keydown", e => {
    const k = e.key.toLowerCase();
    if (handle.localKeys && handle.localKeys.has(k) && handle.onHostKey) {
      handle.onHostKey(k);
      return;
    }
    if (k === "r") resetView();
    else if (k === "p") points = !points;
    else if (k === "n") normalViz = !normalViz;
    else if (k === "l") shaded = !shaded;
  });
  loop();
  return handle;
}
"""

PAGE_CSS = """
  html, body { margin: 0; height: 100%; overflow: hidden; background: #101418; }
  canvas { width: 100%; height: 100%; display: block; }
  #hud { position: fixed; left: 10px; top: 8px; color: #9fb3c8;
         font: 12px/1.5 monospace; user-select: none; pointer-events: none;
         white-space: pre; text-shadow: 0 1px 2px #000; }
"""
