"""Engine: owns every subsystem and drives the frame loop
(ref: src/core/engine.rs + the per-frame orchestration of src/core/app.rs).

The reference couples this to a winit window; here the engine is headless —
the viewer (viewer/) is an optional frontend that feeds it input and streams
the framebuffer out. ``update()`` is the analog of App::update + handle_redraw
(app.rs:128-163, 285-340): poll async scene loads, advance the camera,
advance the accumulation protocol, render.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np

from ray_tracer_2_tpu.config import (RENDER_SIZE, DebugMode, RenderParams,
                                     pick_motion_scale)
from ray_tracer_2_tpu.engine.export import save_png
from ray_tracer_2_tpu.engine.renderer import Renderer
from ray_tracer_2_tpu.assets.manager import AssetManager
from ray_tracer_2_tpu.scene.manager import SceneManager
from ray_tracer_2_tpu.scene.scenes import SceneName

log = logging.getLogger(__name__)


class FrameTiming:
    """Half-life running average of the frame time (engine.rs:180-201)."""

    def __init__(self):
        self.delta = 0.0
        self.average_frame_time = 0.0
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        self.delta = now - self._last
        self._last = now
        self.average_frame_time = (self.average_frame_time + self.delta) / 2.0
        return self.delta

    def reset(self) -> None:
        self.average_frame_time = 0.0

    @property
    def fps(self) -> float:
        return 1.0 / self.average_frame_time if self.average_frame_time > 0 else 0.0


@dataclasses.dataclass
class FrameStats:
    """Live metrics (ref: egui Debug panel, egui.rs:383-402)."""

    frame: int = 0
    fps: float = 0.0
    frame_time_ms: float = 0.0
    mrays_per_s: float = 0.0
    accumulated_frames: int = 0
    bvh_nodes: int = 0
    bvh_triangles: int = 0
    #: True when frame_time_ms/mrays_per_s come from a synchronous timing;
    #: async frames report the dispatch->settle upper bound instead (the
    #: previous frame is settled at the next update()).
    timing_exact: bool = True


class Engine:
    """engine.rs:216-264: construct subsystems, load the initial scene
    (CornellBox, skybox on, 5 bounces, 1 rpp — engine.rs:241-251)."""

    def __init__(self, width: int = RENDER_SIZE[0], height: int = RENDER_SIZE[1],
                 assets: AssetManager | None = None,
                 initial_scene: SceneName | None = SceneName.CORNELL_BOX,
                 block_on_initial_scene: bool = False):
        self.params = RenderParams(width=width, height=height, bounces=5,
                                   rays_per_pixel=1, skybox=True, frames=0,
                                   accumulate=True)
        self._base_resolution = (width, height)
        self.assets = assets or AssetManager()
        self.scene_manager = SceneManager(self.assets)
        self.renderer = Renderer()
        self.timing = FrameTiming()
        self.stats = FrameStats()
        self._frame_counter = 0
        self._last_render_s = 0.0
        self._last_params = self.params
        self._scene_for_stats = None
        self._pending_fb = None
        self._pending_t0 = 0.0
        self._settle_lock = threading.Lock()
        self._timing_exact = True
        self._motion_scale = 2          # adaptive-motion ladder state
        self._last_move_scale: int | None = None
        self._moved_last_frame = False
        if initial_scene is not None:
            if block_on_initial_scene:
                self.scene_manager.load_blocking(initial_scene)
            else:
                self.scene_manager.request_scene(initial_scene)

    # ------------------------------------------------------------ frame

    def update(self, dt: float | None = None, is_moving: bool = False,
               sync: bool = False):
        """One frame: poll scene loads → camera → params protocol → render.
        Returns the device framebuffer (None while no scene is loaded).

        Dispatch is ASYNC by default: the call returns as soon as the frame
        is enqueued, so host work (input, streaming, the next frame's params)
        overlaps device compute — the analog of the reference's separate
        UI/render threads (README.md:5). ``sync=True`` blocks for exact
        per-frame timing.
        """
        if dt is None:
            dt = self.timing.tick()
        else:
            self.timing.delta = dt
            self.timing.average_frame_time = (
                self.timing.average_frame_time + dt) / 2.0

        if self.scene_manager.poll_loaded() is not None:
            # New scene arrived: reset accumulation + timing (app.rs:135-142).
            self.params = self.params.reset_frame()
            self.timing.reset()

        scene = self.scene_manager.scene
        if scene is None:
            return None

        moved = scene.camera.update_camera(dt) or is_moving
        if moved:
            scene.refresh_camera()
        self.params, _ = self.params.update(moved)

        # Async mode: settle the PREVIOUS frame first. Its device work must
        # finish before this dispatch reuses the donated framebuffer anyway,
        # so blocking here is free — and (now - previous t0) upper-bounds the
        # true device render time much tighter than the host loop dt did.
        # (Settled before for_render so the adaptive ladder sees the
        # previous moving frame's measured time.)
        self._settle_pending()

        motion_scale = 2  # reference parity: fixed half res (app.rs:58-73)
        if self.params.adaptive_motion:
            if moved and self._moved_last_frame \
                    and self._last_move_scale is not None:
                self._motion_scale = pick_motion_scale(
                    self._last_move_scale, self._last_render_s,
                    self.params.motion_target_ms / 1000.0)
            motion_scale = self._motion_scale
        render_params = self.params.for_render(moved,
                                               motion_scale=motion_scale)
        self._moved_last_frame = moved
        if moved:
            self._last_move_scale = motion_scale

        t0 = time.perf_counter()
        fb = self.renderer.render(scene.render_scene, render_params)
        if sync:
            fb.block_until_ready()
            self._last_render_s = time.perf_counter() - t0
            self._timing_exact = True
        else:
            self._pending_fb = fb
            self._pending_t0 = t0
            self._timing_exact = False

        self._frame_counter += 1
        self._last_params = render_params
        self._scene_for_stats = scene
        return fb

    def _settle_pending(self, block: bool = True) -> None:
        # Called from the render loop (block=True) AND from stats reads on
        # viewer HTTP threads (block=False): without the lock, _pending_fb
        # can become None between the check and .is_ready(). Non-blocking
        # callers that lose the race just return — someone else is already
        # settling, and they'll read the refreshed snapshot.
        if not self._settle_lock.acquire(blocking=block):
            return
        try:
            fb = self._pending_fb
            if fb is None:
                return
            if not block and not fb.is_ready():
                return
            fb.block_until_ready()
            self._last_render_s = time.perf_counter() - self._pending_t0
            self._pending_fb = None
            # Snapshot stats NOW, while renderer.last_segments still refers
            # to the frame that just settled (and is free to read) — a
            # stats read while the NEXT frame is in flight returns this
            # snapshot instead of blocking on (or starving behind) it.
            self._refresh_stats()
        finally:
            self._settle_lock.release()

    def _refresh_stats(self) -> None:
        scene = getattr(self, "_scene_for_stats", None)
        if scene is None:
            return
        segs = self.renderer.last_segments
        p = self._last_params
        rays = (float(segs) if segs is not None else
                p.width * p.height * max(p.rays_per_pixel, 1))
        render_s = max(self._last_render_s, 1e-9)
        self._stats = FrameStats(
            frame=self._frame_counter,
            fps=self.timing.fps,
            frame_time_ms=render_s * 1e3,
            mrays_per_s=rays / render_s / 1e6,
            accumulated_frames=max(self.params.frames, 0),
            bvh_nodes=scene.n_nodes,
            bvh_triangles=scene.n_triangles,
            timing_exact=self._timing_exact,
        )

    @property
    def stats(self) -> FrameStats:
        """Live metrics. NON-BLOCKING: while an async frame is in flight the
        numbers snapshotted when the PREVIOUS frame settled are returned
        (``timing_exact=False``), so a stats read in a tight host loop never
        serializes async dispatch — and, because every settle refreshes the
        snapshot, never starves either (a continuously-dispatching render
        loop used to pin this at the initial zeros)."""
        if getattr(self, "_scene_for_stats", None) is None:
            return self._stats
        self._settle_pending(block=False)
        if self._pending_fb is None:
            self._refresh_stats()   # sync path / idle: compute live
        return self._stats

    @stats.setter
    def stats(self, value) -> None:
        self._stats = value

    # ------------------------------------------------------- UI actions
    # Hotkey analogs (app.rs:172-272): Q next scene, E cycle debug mode,
    # P save PNG, 1 toggle skybox, 2 toggle accumulate.

    def next_scene(self) -> None:
        cur = self.scene_manager.selected_scene or SceneName.CORNELL_BOX
        self.scene_manager.request_scene(cur.next())

    def cycle_debug_mode(self) -> None:
        mode = DebugMode((int(self.params.debug_mode) + 1) % 8)
        self.params = dataclasses.replace(self.params, debug_mode=mode,
                                          frames=-1)

    def toggle_low_res(self) -> None:
        """R key (app.rs:236-246): halve/restore the session resolution."""
        w, h = self.params.width, self.params.height
        if (w, h) == self._base_resolution:
            w, h = w // 2, h // 2
        else:
            w, h = self._base_resolution
        self.params = dataclasses.replace(self.params, width=w, height=h,
                                          frames=-1)

    def set_resolution(self, width: int, height: int) -> None:
        """Debug-panel resolution drag (egui.rs:434-446)."""
        self.params = dataclasses.replace(
            self.params, width=max(int(width), 8), height=max(int(height), 8),
            frames=-1)

    def rebuild_bvh(self, quality: str) -> None:
        """Debug-panel BVH quality combo + rebuild (egui.rs:404-460)."""
        from ray_tracer_2_tpu.accel.bvh import BVHQuality
        self.scene_manager.rebuild_bvh(BVHQuality(quality))

    def toggle_skybox(self) -> None:
        self.params = dataclasses.replace(
            self.params, skybox=not self.params.skybox, frames=-1)

    def toggle_accumulate(self) -> None:
        self.params = dataclasses.replace(
            self.params, accumulate=not self.params.accumulate)

    def save_render(self, path) -> None:
        """PNG export with gamma 1/2.2 (app.rs:341-465)."""
        fb = self.renderer.read_framebuffer()
        save_png(fb, path)
        log.info("saved render to %s", path)
