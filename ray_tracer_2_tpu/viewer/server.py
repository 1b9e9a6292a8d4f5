"""Interactive browser viewer — the reference's window + egui UI reborn
(ref: src/core/app.rs event loop, src/rendering/egui.rs panels).

The reference couples rendering to a winit window and egui immediate-mode UI.
On a headless GPU host the equivalent split is: the render loop runs in a
Python thread (async device dispatch), and a stdlib HTTP server streams the
framebuffer to a browser canvas while receiving input events back — the same
UI/render separation the reference gets from its thread split (README.md:5).

Endpoints:
  GET  /            viewer page (canvas + inspector/debug panels)
  GET  /frame.jpg   latest framebuffer (JPEG, gamma-encoded)
  GET  /state       stats + params JSON (egui Debug panel, egui.rs:378-484)
  POST /input       {keys, mouse, wheel, set: {param: value}, action: ...}

Key bindings mirror app.rs:172-272: WASD/arrows+Space/Shift move, Q next
scene, E cycle debug mode, P save PNG, F fullscreen (browser-side), R low-res
toggle, 1 skybox, 2 accumulate, Esc releases the mouse.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ray_tracer_2_tpu.config import DebugMode
from ray_tracer_2_tpu.engine.engine import Engine
from ray_tracer_2_tpu.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu.scene.scenes import SceneName
from ray_tracer_2_tpu.viewer.ws import upgrade as ws_upgrade

log = logging.getLogger(__name__)

_HTML_PATH = Path(__file__).with_name("viewer.html")


class ViewerServer:
    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8000, jpeg_quality: int = 85):
        self.engine = engine
        self.host = host
        self.port = port
        self.jpeg_quality = jpeg_quality
        self._frame_jpeg: bytes = b""
        self._frame_id = 0
        self._lock = threading.Lock()
        self._frame_cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._moving_until = 0.0
        self._input_ms = 0.0   # last WS input handling time (ms)
        self._httpd: ThreadingHTTPServer | None = None
        self._selected: dict | None = None   # {"kind","index"} gizmo target
        self._drag_ctx: dict | None = None   # depth plane + grab offset
        self._aabb_cache: dict = {}          # inst index -> (lo, hi)
        self._aabb_scene = None              # HostScene the cache belongs to

    # ------------------------------------------------------- render loop

    def _render_loop(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            moving = time.monotonic() < self._moving_until
            fb = eng.update(is_moving=moving)
            if fb is None:
                time.sleep(0.05)
                continue
            img = framebuffer_to_srgb(eng.renderer.read_framebuffer())
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG",
                                      quality=self.jpeg_quality)
            with self._frame_cv:
                self._frame_jpeg = buf.getvalue()
                self._frame_id += 1
                self._frame_cv.notify_all()

    # ------------------------------------------------------------ input

    def handle_input(self, msg: dict) -> None:
        eng = self.engine
        scene = eng.scene_manager.scene
        cam = scene.camera if scene else None

        for key, pressed in msg.get("keys", {}).items():
            if cam is not None:
                cam.controller.process_keyboard(key, bool(pressed))
            if pressed:
                self._hotkey(key)
        mouse = msg.get("mouse")
        if mouse and cam is not None:
            cam.controller.process_mouse(mouse[0], mouse[1])
            self._moving_until = time.monotonic() + 0.15
        wheel = msg.get("wheel")
        if wheel and cam is not None:
            cam.controller.process_scroll(float(wheel))
        if any(msg.get("keys", {}).values()):
            self._moving_until = time.monotonic() + 0.15

        for name, value in (msg.get("set") or {}).items():
            self._set_param(name, value)

        edit = msg.get("edit_entity")
        if edit is not None:
            self._edit_entity(edit)

        pick = msg.get("pick")
        if pick is not None:
            self._pick(float(pick[0]), float(pick[1]))
        drag = msg.get("drag")
        if drag is not None:
            self._drag(float(drag[0]), float(drag[1]))
        if msg.get("drag_end"):
            self._drag_ctx = None

    _MAT_FIELDS = ("color", "emission_color", "specular_color",
                   "emission_strength", "smoothness", "specular", "ior",
                   "flag", "absorption", "absorption_strength")

    def _edit_entity(self, edit: dict) -> None:
        """Selected-entity property editing — full parity with the reference
        inspector (egui.rs:156-365): sphere position/radius, instance
        position/rotation/scale (partial edits preserve the untouched
        components), and material fields on both; edits reset accumulation."""
        scene = self.engine.scene_manager.scene
        if scene is None:
            return
        kind = edit.get("kind")
        idx = int(edit.get("index", 0))
        mat_fields = {k: v for k, v in edit.items() if k in self._MAT_FIELDS}
        if kind == "sphere" and 0 <= idx < scene.n_spheres:
            if "centre" in edit or "radius" in edit:
                scene.edit_sphere(idx, centre=edit.get("centre"),
                                  radius=edit.get("radius"))
            if mat_fields:
                mid = int(np.asarray(scene.render_scene.sphere_mat)[idx])
                scene.edit_material(mid, **mat_fields)
        elif kind == "instance" and 0 <= idx < scene.n_instances:
            rot = None
            if "transform_rot" in edit:  # quaternion (x, y, z, w)
                rot = edit["transform_rot"]
            elif "transform_euler_deg" in edit:  # yaw/pitch/roll degrees
                from ray_tracer_2_tpu.math.transform import quat_from_euler_yxz
                y, p, r = (float(v) * np.pi / 180.0
                           for v in edit["transform_euler_deg"])
                rot = quat_from_euler_yxz(y, p, r)
            if ("transform_pos" in edit or "transform_scale" in edit
                    or rot is not None):
                scene.edit_instance_transform(
                    idx, pos=edit.get("transform_pos"), rot=rot,
                    scale=edit.get("transform_scale"))
            if mat_fields:
                for mid in scene.inst_material_ids[idx]:
                    scene.edit_material(mid, **mat_fields)
        self.engine.params = dataclasses.replace(self.engine.params, frames=-1)

    # -------------------------------------------------- pick/drag gizmo

    def _pixel_ray(self, u: float, v: float):
        """World ray through DISPLAY-normalized (u, v) ∈ [0,1]² (origin
        top-left, as the browser sees the streamed JPEG). The stream is the
        framebuffer flipped vertically (engine/export.py), so display v
        maps to framebuffer row (1-v)·(H-1); from there the mapping is the
        kernel's own (kernels/trace.py camera_ray_basis, no DoF jitter)."""
        eng = self.engine
        scene = eng.scene_manager.scene
        if scene is None:
            return None, None
        cu = scene.camera.to_uniform()
        fx = u - 0.5
        fy = (1.0 - v) - 0.5
        local = np.array([fx * cu.view_params[0], fy * cu.view_params[1],
                          cu.view_params[2]], np.float64)
        m = np.asarray(cu.cam_to_world, np.float64)
        origin = m[:3, 3]
        d = m[:3, :3] @ local
        return origin, d / np.linalg.norm(d)

    def _inst_aabb(self, scene, i: int):
        # the cache is scoped to ONE HostScene object: _aabb_scene holds a
        # strong reference (so a freed scene's id can never be reused while
        # entries exist) and a scene switch clears the dict — no stale
        # boxes, bounded size (review finding)
        if self._aabb_scene is not scene:
            self._aabb_cache.clear()
            self._aabb_scene = scene
        key = i
        box = self._aabb_cache.get(key)
        if box is None:
            rs = scene.render_scene
            _, toff, cnt = rs.inst_spans[i]
            sl = slice(toff, toff + cnt)
            vs = np.concatenate([np.asarray(rs.tri_v0[sl]),
                                 np.asarray(rs.tri_v1[sl]),
                                 np.asarray(rs.tri_v2[sl])])
            box = (vs.min(axis=0), vs.max(axis=0)) if len(vs) else None
            self._aabb_cache[key] = box
        return box

    def _pick(self, u: float, v: float) -> None:
        """Select the entity under the cursor (nearest sphere quadratic or
        instance model-space AABB hit) and arm the drag plane: entity
        translations track the cursor on the camera-forward plane through
        the entity's position (the egui gizmo analog, egui.rs:156-365)."""
        eng = self.engine
        scene = eng.scene_manager.scene
        origin, d = self._pixel_ray(u, v)
        if origin is None:
            return
        best = (np.inf, None)
        rs = scene.render_scene
        pos = np.asarray(rs.sphere_pos, np.float64)
        rad = np.asarray(rs.sphere_radius, np.float64)
        for i in range(scene.n_spheres):
            oc = origin - pos[i]
            b = np.dot(oc, d)
            disc = b * b - (np.dot(oc, oc) - rad[i] * rad[i])
            if disc < 0:
                continue
            t = -b - np.sqrt(disc)
            if t < 1e-3:
                t = -b + np.sqrt(disc)
            if 1e-3 < t < best[0]:
                best = (t, dict(kind="sphere", index=i))
        for i in range(scene.n_instances):
            box = self._inst_aabb(scene, i)
            if box is None:
                continue
            w2m = np.asarray(rs.inst_world_to_model[i], np.float64)
            om = (w2m[:3, :3] @ origin) + w2m[:3, 3]
            dm = w2m[:3, :3] @ d
            dm /= np.linalg.norm(dm)
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (box[0] - om) / dm
                t2 = (box[1] - om) / dm
            tn = np.nanmax(np.minimum(t1, t2))
            tf = np.nanmin(np.maximum(t1, t2))
            if tf >= tn and tf > 0:
                # entry distance back in world units (uniform direction map)
                m2w = np.asarray(rs.inst_model_to_world[i], np.float64)
                tw = max(tn, 0.0) * np.linalg.norm(m2w[:3, :3] @ dm)
                if 1e-3 < tw < best[0]:
                    best = (tw, dict(kind="instance", index=i))
        self._selected = best[1]
        self._drag_ctx = None
        if best[1] is None:
            return
        ent_pos = self._entity_pos(scene, best[1])
        fwd = np.asarray(scene.camera.to_uniform().cam_to_world,
                         np.float64)[:3, 2]
        depth = float(np.dot(ent_pos - origin, fwd))
        t_hit = depth / float(np.dot(d, fwd))
        self._drag_ctx = dict(depth=depth,
                              offset=ent_pos - (origin + d * t_hit))

    def _entity_pos(self, scene, sel) -> np.ndarray:
        rs = scene.render_scene
        if sel["kind"] == "sphere":
            return np.asarray(rs.sphere_pos, np.float64)[sel["index"]]
        return np.asarray(scene.inst_transforms[sel["index"]].pos, np.float64)

    def _drag(self, u: float, v: float) -> None:
        """Move the selected entity so it follows the cursor on the armed
        camera-forward plane (constant view depth); resets accumulation via
        the edit path."""
        scene = self.engine.scene_manager.scene
        if scene is None or self._selected is None or self._drag_ctx is None:
            return
        origin, d = self._pixel_ray(u, v)
        fwd = np.asarray(scene.camera.to_uniform().cam_to_world,
                         np.float64)[:3, 2]
        denom = float(np.dot(d, fwd))
        if abs(denom) < 1e-9:
            return
        t = self._drag_ctx["depth"] / denom
        new_pos = origin + d * t + self._drag_ctx["offset"]
        sel = self._selected
        if sel["kind"] == "sphere":
            scene.edit_sphere(sel["index"], centre=[float(x) for x in new_pos])
        else:
            scene.edit_instance_transform(sel["index"],
                                          pos=[float(x) for x in new_pos])
        self.engine.params = dataclasses.replace(self.engine.params,
                                                 frames=-1)
        self._moving_until = time.monotonic() + 0.15

    def _hotkey(self, key: str) -> None:
        eng = self.engine
        if key == "q":
            eng.next_scene()
        elif key == "e":
            eng.cycle_debug_mode()
        elif key == "p":
            eng.save_render(f"render_{int(time.time())}.png")
        elif key == "r":
            eng.toggle_low_res()
        elif key == "1":
            eng.toggle_skybox()
        elif key == "2":
            eng.toggle_accumulate()

    def _set_param(self, name: str, value) -> None:
        """Inspector edits (egui.rs:87-376): any change resets accumulation
        (egui.rs:498-507)."""
        eng = self.engine
        p = eng.params
        if name in ("bounces", "rays_per_pixel", "debug_scale"):
            eng.params = dataclasses.replace(p, **{name: int(value)}, frames=-1)
        elif name in ("skybox", "accumulate", "normal_maps", "antialias",
                      "nee"):
            eng.params = dataclasses.replace(p, **{name: bool(value)}, frames=-1)
        elif name == "adaptive_motion":
            # host-side policy knob: no accumulation reset needed
            eng.params = dataclasses.replace(p, adaptive_motion=bool(value))
        elif name == "motion_target_ms":
            eng.params = dataclasses.replace(p,
                                             motion_target_ms=int(value))
        elif name == "debug_mode":
            eng.params = dataclasses.replace(p, debug_mode=DebugMode(int(value)),
                                             frames=-1)
        elif name == "scene":
            eng.scene_manager.request_scene(SceneName(value))
        elif name == "resolution":
            w, h = (int(v) for v in str(value).lower().split("x"))
            eng.set_resolution(w, h)
        elif name == "bvh_quality":
            eng.rebuild_bvh(str(value))
        elif name in ("fov", "focus_dist", "defocus_strength",
                      "diverge_strength"):
            scene = eng.scene_manager.scene
            if scene is not None:
                setattr(scene.camera, name, float(value))
                scene.refresh_camera()
                eng.params = dataclasses.replace(p, frames=-1)

    # ------------------------------------------------------------ state

    def state(self) -> dict:
        eng = self.engine
        s = eng.stats
        scene = eng.scene_manager.scene
        return dict(
            frame=s.frame, fps=round(s.fps, 1),
            frame_time_ms=round(s.frame_time_ms, 2),
            mrays_per_s=round(s.mrays_per_s, 2),
            accumulated_frames=s.accumulated_frames,
            bvh_nodes=s.bvh_nodes, bvh_triangles=s.bvh_triangles,
            n_spheres=scene.n_spheres if scene else 0,
            n_instances=scene.n_instances if scene else 0,
            entities=self._entities(scene),
            scene=(eng.scene_manager.selected_scene.value
                   if eng.scene_manager.selected_scene else None),
            scenes=[n.value for n in SceneName.all()],
            params=dict(
                width=eng.params.width, height=eng.params.height,
                bounces=eng.params.bounces,
                rays_per_pixel=eng.params.rays_per_pixel,
                skybox=eng.params.skybox, accumulate=eng.params.accumulate,
                normal_maps=eng.params.normal_maps,
                antialias=eng.params.antialias,
                nee=eng.params.nee,
                adaptive_motion=eng.params.adaptive_motion,
                motion_target_ms=eng.params.motion_target_ms,
                debug_mode=int(eng.params.debug_mode),
                debug_scale=eng.params.debug_scale,
            ),
            camera=(dict(pos=[float(v) for v in scene.camera.transform.pos],
                         fov=scene.camera.fov,
                         focus_dist=scene.camera.focus_dist,
                         defocus_strength=scene.camera.defocus_strength,
                         diverge_strength=scene.camera.diverge_strength)
                    if scene else None),
            frame_id=self._frame_id,
            input_ms=round(self._input_ms, 2),
            selected=self._selected,
        )

    def _entities(self, scene) -> dict:
        """Entity listing for the inspector (egui.rs:156-179 selection)."""
        if scene is None:
            return dict(spheres=[], instances=[])
        from ray_tracer_2_tpu.math.transform import quat_to_euler_yxz
        rs = scene.render_scene
        pos = np.asarray(rs.sphere_pos)
        rad = np.asarray(rs.sphere_radius)
        spheres = [dict(centre=[round(float(v), 3) for v in pos[i]],
                        radius=round(float(rad[i]), 3))
                   for i in range(scene.n_spheres)]
        instances = []
        for i, t in enumerate(scene.inst_transforms):
            e = quat_to_euler_yxz(t.rot)
            instances.append(dict(
                pos=[round(float(v), 3) for v in t.pos],
                euler_deg=[round(float(v) * 180.0 / np.pi, 1) for v in e],
                scale=[round(float(v), 3) for v in t.scale],
                triangles=scene.render_scene.inst_spans[i][2],
                materials=scene.inst_material_ids[i]))
        return dict(spheres=spheres, instances=instances)

    # ----------------------------------------------------------- server

    def serve_forever(self) -> None:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            # RFC 6455 requires an HTTP/1.1 101 status line — the 1.0
            # default makes every real browser reject the WS handshake
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, _HTML_PATH.read_bytes(),
                               "text/html; charset=utf-8")
                elif self.path.startswith("/frame.jpg"):
                    with viewer._lock:
                        data = viewer._frame_jpeg
                    self._send(200 if data else 503, data or b"loading",
                               "image/jpeg" if data else "text/plain")
                elif self.path.startswith("/stream.mjpg"):
                    # PUSH stream (multipart/x-mixed-replace): frames go
                    # out the moment the render loop produces them — no
                    # per-frame request round-trip like /frame.jpg
                    # polling. Runs on its own handler thread
                    # (ThreadingHTTPServer).
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=rt2frame")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    last = -1
                    try:
                        while not viewer._stop.is_set():
                            with viewer._frame_cv:
                                if viewer._frame_id == last:
                                    viewer._frame_cv.wait(timeout=1.0)
                                if viewer._frame_id == last:
                                    continue  # idle: don't re-send the frame
                                data = viewer._frame_jpeg
                                last = viewer._frame_id
                            if not data:
                                continue
                            self.wfile.write(
                                b"--rt2frame\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                b"Content-Length: "
                                + str(len(data)).encode() + b"\r\n\r\n")
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away
                elif self.path.startswith("/state"):
                    self._send(200, json.dumps(viewer.state()).encode(),
                               "application/json")
                elif self.path.startswith("/ws"):
                    # WebSocket INPUT channel (viewer/ws.py): one persistent
                    # connection replaces a POST round-trip per input event
                    # — the browser analog of the reference's in-process
                    # winit event queue (app.rs:172-272). {"ping": t}
                    # messages echo {"pong": t} so the client can display
                    # a measured input round-trip latency.
                    sock = ws_upgrade(self)
                    if sock is None:
                        return
                    try:
                        while not viewer._stop.is_set():
                            text = sock.recv_text()
                            if text is None:
                                break
                            msg = json.loads(text)
                            if not isinstance(msg, dict):
                                continue
                            if "ping" in msg:
                                sock.send_text(json.dumps(
                                    {"pong": msg["ping"]}))
                                continue
                            t0 = time.perf_counter()
                            try:
                                viewer.handle_input(msg)
                            except Exception:
                                # bad client input (malformed pick/drag/
                                # edit payloads) must not kill the input
                                # channel — match the POST /input policy
                                log.exception("bad /ws input: %r", msg)
                            viewer._input_ms = \
                                (time.perf_counter() - t0) * 1e3
                    except (OSError, ValueError):
                        pass  # client went away / bad frame
                    finally:
                        sock.close()
                        self.close_connection = True
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.startswith("/input"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        msg = json.loads(self.rfile.read(n) or b"{}")
                        viewer.handle_input(msg)
                        self._send(200, b"{}", "application/json")
                    except Exception as e:  # bad client input must not kill the UI
                        log.exception("bad /input")
                        self._send(400, str(e).encode(), "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

        render_thread = threading.Thread(target=self._render_loop, daemon=True)
        render_thread.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        log.info("viewer at http://%s:%d", self.host, self.port)
        try:
            self._httpd.serve_forever()
        finally:
            self._stop.set()

    def shutdown(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()


def run_viewer(width: int = 960, height: int = 540,
               scene: SceneName = SceneName.CORNELL_BOX,
               host: str = "127.0.0.1", port: int = 8000) -> None:
    engine = Engine(width=width, height=height, initial_scene=scene)
    ViewerServer(engine, host=host, port=port).serve_forever()


if __name__ == "__main__":
    from ray_tracer_2_tpu.utils.compile_cache import enable_compile_cache
    logging.basicConfig(level=logging.INFO)
    enable_compile_cache()
    run_viewer()
