"""Live visualization: detection/disparity windows and an interactive
3D point-cloud viewer (counterpart of stereovision_tpu/viz_live.py, name
for name).

Replaces the reference's display surfaces:
  * the freeglut point-cloud viewer thread with WASD/RF camera motion and
    tracked-object cubes (src/common_includes/graphing.h:30-305)
  * the "Detections"/"Disparity" imshow windows
    (src/serial_includes/main/stereo_vision.cpp:616-620)
  * box + label + FPS overlays burned into frames
    (src/common_includes/yolo/detector.cpp:75-111)

The renderer takes the cloud where it lies: a tensor on the card stays
there, the z-buffer runs on the renderer's device (the card unless the
caller passes device="cpu"), and only the finished (H, W, 3) image comes
back to the host.  The image equals the JAX package's NumPy renderer's:
the projection in float64 with every product and sum a separate
operation, the bounds checked in float64 before the integer cast, and
"sorted far to near, later writes win" made deterministic as a
scatter-max of each write's position in that order.

The overlays need no cv2: boxes and label backgrounds are cv2's pixel
sets, the text comes from font.py's glyph tables.  cv2 is used only where
the JAX module uses it as an option: showing windows, pumping keys,
writing PNGs, and cube labels.  On a display-less host `LiveViewer`
renders only, and can spool the rendered frames to disk.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .font import put_text, text_size


# ---------------------------------------------------------------------------
# 2D overlays (detector.cpp:75-111 drawPred + FPS text)

def _rectangle(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """cv2.rectangle(img, p0, p1, color, thickness)'s pixels, in place and
    clipped: filled for thickness < 0, else the band of half-width
    thickness // 2 around the outline with its corners rounded (held
    against cv2 at thickness 1, 2 and filled)."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    r = 0 if thickness < 0 else thickness // 2
    ya, yb = max(y0 - r, 0), min(y1 + r + 1, h)
    xa, xb = max(x0 - r, 0), min(x1 + r + 1, w)
    if ya >= yb or xa >= xb:
        return
    yy, xx = np.ogrid[ya:yb, xa:xb]
    mask = np.ones((yb - ya, xb - xa), bool)
    if thickness >= 0:
        mask &= ~((xx > x0 + r) & (xx < x1 - r) & (yy > y0 + r)
                  & (yy < y1 - r))
        dx = np.maximum(np.maximum(x0 - xx, xx - x1), 0)
        dy = np.maximum(np.maximum(y0 - yy, yy - y1), 0)
        mask &= dx * dx + dy * dy <= r * r
    img[ya:yb, xa:xb][mask] = color


def draw_detections(frame: np.ndarray, detections: Sequence,
                    fps: Optional[float] = None,
                    thickness: int = 2) -> np.ndarray:
    """Burn detection boxes + "name: conf" labels (+ FPS, top-left) into a
    copy of the BGR frame.  Works with the Detection dataclass or any
    object with .x/.y/.w/.h/.name/.conf/.r/.g/.b.  The JAX function's
    cv2 calls, drawn by this module: the boxes and the label backgrounds
    pixel for pixel, the text from font.py's glyphs."""
    out = np.ascontiguousarray(frame).copy()
    for d in detections:
        color = (int(d.b * 255), int(d.g * 255), int(d.r * 255))
        x0, y0 = int(d.x), int(d.y)
        x1, y1 = int(d.x + d.w), int(d.y + d.h)
        _rectangle(out, (x0, y0), (x1, y1), color, thickness)
        label = "%s: %.2f" % (d.name, d.conf)
        (tw, th), base = text_size(label, 0.5, 1)
        ty = max(y0, th + 2)
        _rectangle(out, (x0, ty - th - 2), (x0 + tw, ty + base),
                   (255, 255, 255), -1)
        put_text(out, label, (x0, ty), 0.5, 1, (0, 0, 0))
    if fps is not None:
        put_text(out, "FPS: %.2f" % fps, (8, 24), 0.7, 2, (0, 255, 0))
    return out


# ---------------------------------------------------------------------------
# 3D camera (graphing.h WASD/RF/arrow semantics)

@dataclasses.dataclass
class Camera:
    """First-person camera: position + yaw/pitch (radians).  The world is
    the reconstruction frame (x right, y down, z forward), so the default
    pose looks straight down +z from the origin, like the physical rig.
    Host-side float64, as in the JAX package."""
    x: float = 0.0
    y: float = 0.0
    z: float = -5.0
    yaw: float = 0.0
    pitch: float = 0.0
    move_step: float = 0.5
    turn_step: float = 0.05

    def rotation(self) -> np.ndarray:
        """World -> camera rotation matrix (3, 3)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        # yaw about the (down) y axis, then pitch about the camera x axis
        r_yaw = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
        r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        return r_pitch @ r_yaw

    def forward(self) -> np.ndarray:
        return self.rotation().T @ np.array([0.0, 0.0, 1.0])

    def right(self) -> np.ndarray:
        return self.rotation().T @ np.array([1.0, 0.0, 0.0])

    def handle_key(self, key: str) -> bool:
        """WASD strafe/advance, R/F up/down, arrows (or ijkl) look.
        Returns True if the pose changed (graphing.h keyboard handler)."""
        f, r = self.forward(), self.right()
        moves = {
            "w": f * self.move_step, "s": -f * self.move_step,
            "d": r * self.move_step, "a": -r * self.move_step,
            "r": np.array([0, -self.move_step, 0.0]),
            "f": np.array([0, self.move_step, 0.0]),
        }
        if key in moves:
            self.x, self.y, self.z = np.array([self.x, self.y, self.z]) \
                + moves[key]
            return True
        turns = {"left": (-1, 0), "right": (1, 0), "up": (0, -1),
                 "down": (0, 1), "j": (-1, 0), "l": (1, 0), "i": (0, -1),
                 "k": (0, 1)}
        if key in turns:
            dy, dp = turns[key]
            self.yaw += dy * self.turn_step
            self.pitch = float(np.clip(self.pitch + dp * self.turn_step,
                                       -1.5, 1.5))
            return True
        return False


# ---------------------------------------------------------------------------
# 3D point renderer

class PointCloudRenderer:
    """Z-buffered perspective point splatter (+ wireframe cuboids for
    tracked objects).  The points are splatted on `device` (the card
    unless device="cpu"); cuboids are drawn on the host into the fetched
    image."""

    def __init__(self, width: int = 960, height: int = 540,
                 fov_deg: float = 60.0, point_px: int = 1, device=None):
        self.w, self.h = int(width), int(height)
        self.f = 0.5 * self.w / math.tan(math.radians(fov_deg) / 2)
        self.point_px = int(point_px)
        self.device = resolve_device(device)
        self._rings = None

    def _upload(self, points) -> torch.Tensor:
        """Points (NumPy or a tensor, (N, 3) or (H, W, 3)) -> an (N, 3)
        float64 tensor on the renderer's device."""
        if not torch.is_tensor(points):
            points = torch.from_numpy(np.asarray(points, np.float64))
        return points.to(self.device, torch.float64).reshape(-1, 3)

    def project(self, points, cam: Camera):
        """(N, 3) world points -> (u, v, depth) + validity mask, tensors on
        the renderer's device (u, v int32; depth float64)."""
        return self._project(self._upload(points), cam)

    def _project(self, p: torch.Tensor, cam: Camera):
        """project on p's own device.  Each product and sum is an
        operation of its own, so that no device contracts them into a
        fused multiply-add and every device rounds alike."""
        finite = torch.isfinite(p).all(dim=1)
        d = p - torch.tensor([cam.x, cam.y, cam.z], dtype=torch.float64,
                             device=p.device)
        R = cam.rotation()

        def row(k):
            return d[:, 0] * float(R[k, 0]) + d[:, 1] * float(R[k, 1]) \
                + d[:, 2] * float(R[k, 2])
        z = row(2)
        ok = finite & (z > 1e-3)
        zs = torch.where(ok, z, 1.0)
        xs = torch.where(ok, row(0), 0.0)
        ys = torch.where(ok, row(1), 0.0)
        uf = self.f * xs / zs + self.w / 2
        vf = self.f * ys / zs + self.h / 2
        # the JAX package casts to int32 first (truncation toward zero)
        # and then keeps 0 <= u < w: the same set is -1 < uf < w, checked
        # here before the cast, whose out-of-range results differ
        # between devices
        ok &= (uf > -1) & (uf < self.w) & (vf > -1) & (vf < self.h)
        u = torch.where(ok, uf, 0.0).to(torch.int32)
        v = torch.where(ok, vf, 0.0).to(torch.int32)
        return u, v, z, ok

    # Ground-plane range rings (reference graphing.h:139-170: red circles
    # of radius 1..9 m at y=0, pi/100 steps, plus a green marker at
    # (0, 0, 1)), generated once as a point set and splatted like any
    # other points.
    @staticmethod
    def _ring_points() -> Tuple[np.ndarray, np.ndarray]:
        theta = np.arange(0.0, 2 * math.pi, math.pi / 100)
        rings = [np.stack([-r * np.sin(theta), np.zeros_like(theta),
                           r * np.cos(theta)], axis=1)
                 for r in range(1, 10)]
        pts = np.concatenate(rings + [np.array([[0.0, 0.0, 1.0]])])
        colors = np.full((len(pts), 3), (0, 0, 255), np.uint8)  # BGR red
        colors[-1] = (0, 255, 0)                                # origin
        return pts, colors

    def _ring_tensors(self):
        if self._rings is None:
            pts, colors = self._ring_points()
            self._rings = (torch.from_numpy(pts).to(self.device),
                           torch.from_numpy(colors).to(self.device))
        return self._rings

    def render(self, points, cam: Camera, colors=None,
               cubes: Optional[Sequence] = None,
               background: int = 12,
               draw_rings: bool = True) -> np.ndarray:
        """Render the cloud (optionally per-point (N, 3) uint8 BGR colors;
        default = depth-shaded), ground-plane range rings, and
        tracked-object cuboids.  points: NumPy or a tensor, (N, 3) or
        (H, W, 3); colors: NumPy.  Returns (H, W, 3) uint8 BGR, as
        NumPy.

        The JAX renderer assigns the rings, then the points sorted far to
        near (a stable sort), once per (dv, du) offset of a point_px
        square, each assignment overwriting the last.  Here every write
        gets its position in that sequence as a key (rings by index, then
        offset * N + rank), each pixel keeps its largest key by a
        scatter-max, and the colours are gathered from the winners."""
        hw = self.h * self.w
        p = self._upload(points)
        n = p.shape[0]
        pix, keys, table = [], [], []
        n_ring = 0
        if draw_rings:
            rp, rc = self._ring_tensors()
            n_ring = len(rp)
            ru, rv, _, rok = self._project(rp, cam)
            # writes off the image go to slot hw, which is dropped
            pix.append(torch.where(rok, rv.long() * self.w + ru.long(), hw))
            keys.append(torch.arange(n_ring, device=self.device))
            table.append(rc)
        u, v, z, ok = self._project(p, cam)
        if colors is not None:
            ci = torch.from_numpy(np.ascontiguousarray(colors)).reshape(
                -1, 3).to(self.device, torch.uint8)
        else:
            zs = torch.where(ok, z, 1.0)
            zmax = (torch.where(ok, z, -math.inf).amax() if n
                    else zs.new_zeros(()))
            shade = (255.0 * (1.0 - zs / (zmax + 1e-9))).clamp(40, 255)
            ci = shade.to(torch.uint8)[:, None].expand(n, 3)
        # rank: the position in a stable sort far to near of the valid
        # points (the others sort after them)
        order = torch.sort(torch.where(ok, -z, math.inf), stable=True).indices
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=self.device))
        table.append(ci[order])
        r = max(self.point_px, 1)
        ui, vi = u.long(), v.long()
        for it, (dv, du) in enumerate(itertools.product(range(r), range(r))):
            vv = (vi + dv).clamp(0, self.h - 1)
            uu = (ui + du).clamp(0, self.w - 1)
            pix.append(torch.where(ok, vv * self.w + uu, hw))
            keys.append(n_ring + it * n + rank)
        winner = torch.full((hw + 1,), -1, dtype=torch.long,
                            device=self.device)
        winner.scatter_reduce_(0, torch.cat(pix), torch.cat(keys), "amax")
        win = winner[:hw]
        img = torch.full((hw, 3), background, dtype=torch.uint8,
                         device=self.device)
        table = torch.cat(table)
        if len(table):
            idx = torch.where(win < n_ring, win,
                              n_ring + (win - n_ring) % max(n, 1))
            img = torch.where((win >= 0)[:, None], table[idx.clamp(min=0)],
                              img)
        img = img.reshape(self.h, self.w, 3).cpu().numpy()
        if cubes:
            for cube in cubes:
                self._draw_cube(img, cube, cam)
        return img

    # -- tracked-object cuboids (graphing.h draws unit cubes at object
    #    world positions) ---------------------------------------------------

    def _draw_cube(self, img: np.ndarray, cube: Dict, cam: Camera):
        c = np.asarray(cube.get("center", (0, 0, 0)), np.float64)
        s = np.asarray(cube.get("size", (1.0, 1.0, 1.0)), np.float64) / 2
        color = cube.get("color", (0, 255, 255))
        corners = np.array([[sx, sy, sz] for sx in (-s[0], s[0])
                            for sy in (-s[1], s[1])
                            for sz in (-s[2], s[2])]) + c
        u, v, z, ok = (t.numpy() for t in self._project(
            torch.from_numpy(corners), cam))
        edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
                 (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
        for a, b in edges:
            if ok[a] and ok[b]:
                _draw_line(img, int(u[a]), int(v[a]), int(u[b]), int(v[b]),
                           color)
        label = cube.get("label")
        if label and ok.any():
            try:
                import cv2
                cv2.putText(img, str(label),
                            (int(u[ok].min()), max(int(v[ok].min()) - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
            except ImportError:
                pass


def _draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color: Tuple[int, int, int]):
    """Bresenham line (keeps the renderer cv2-free)."""
    h, w = img.shape[:2]
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    while True:
        if 0 <= x0 < w and 0 <= y0 < h:
            img[y0, x0] = color
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def tracker_cubes(tracker, positions: Optional[np.ndarray] = None,
                  size: float = 1.0) -> List[Dict]:
    """Cuboids for a BayesianTracker's current objects.  positions: (K, 3)
    world XYZ per tracked box (from StereoEngine.object_positions); when
    absent the cube centers fall back to (0, 0, id) placeholders."""
    cubes = []
    boxes = getattr(tracker, "objects", None) or []
    for k, obj in enumerate(boxes):
        center = (positions[k] if positions is not None
                  and k < len(positions) else (0.0, 0.0, float(k)))
        name = getattr(obj, "name", str(k))
        cubes.append({"center": tuple(np.asarray(center, np.float64)),
                      "size": (size, size, size),
                      "color": (0, 255, 255), "label": name})
    return cubes


# ---------------------------------------------------------------------------
# the interactive loop

_KEYMAP = {81: "left", 82: "up", 83: "right", 84: "down"}


class LiveViewer:
    """Detections/Disparity/Point-Cloud windows with a key pump.

    show() accepts the engine's per-frame output dict; on hosts without a
    display (no $DISPLAY / cv2.imshow failure) it silently degrades to
    render-only, optionally spooling rendered frames to `record_dir` so a
    headless host still produces a watchable sequence.  The cloud is
    rendered on `device` (the card unless device="cpu")."""

    def __init__(self, view3d: bool = True, width: int = 960,
                 height: int = 540, record_dir: Optional[str] = None,
                 device=None):
        self.cam = Camera()
        self.renderer = PointCloudRenderer(width, height, device=device)
        self.view3d = view3d
        self.record_dir = record_dir
        self._frame_idx = 0
        # cv2.imshow on a display-less host can abort the process inside
        # the GUI toolkit (not a catchable exception) — decide headless
        # up front from the environment
        has_display = bool(os.environ.get("DISPLAY")
                           or os.environ.get("WAYLAND_DISPLAY"))
        self._display = None if has_display else False
        if record_dir:
            os.makedirs(record_dir, exist_ok=True)

    def _try_show(self, name: str, img: np.ndarray):
        if self._display is False:
            return
        try:
            import cv2
            cv2.imshow(name, img)
            self._display = True
        except Exception:
            self._display = False

    def show(self, out: Dict, left_bgr: np.ndarray,
             detections: Sequence = (), fps: Optional[float] = None,
             cubes: Optional[Sequence] = None) -> Dict[str, np.ndarray]:
        """Render + display one frame.  Returns the rendered images (so
        headless callers/tests can assert on them).  out["points"] may be
        a tensor on the card: it is rendered there."""
        from .viz import colorize_disparity
        rendered: Dict[str, np.ndarray] = {}
        rendered["detections"] = draw_detections(left_bgr, detections,
                                                 fps=fps)
        dmap = out["dmap"]
        rendered["disparity"] = colorize_disparity(
            dmap.cpu().numpy() if torch.is_tensor(dmap) else np.asarray(dmap))
        self._try_show("Detections", rendered["detections"])
        self._try_show("Disparity", rendered["disparity"])
        if self.view3d and "points" in out:
            pts = out["points"]
            colors = None
            # as in the JAX package: coloured only when the cloud comes
            # as (H*W, 3) (fetch "host"), depth-shaded as (pc_h, pc_w, 3)
            if left_bgr is not None and pts.shape[0] == left_bgr.shape[0] \
                    * left_bgr.shape[1]:
                colors = left_bgr.reshape(-1, 3)
            rendered["cloud"] = self.renderer.render(
                pts, self.cam, colors=colors, cubes=cubes)
            self._try_show("Point Cloud", rendered["cloud"])
        if self.record_dir:
            self._record(rendered)
        self._pump_keys()
        self._frame_idx += 1
        return rendered

    def _record(self, rendered: Dict[str, np.ndarray]):
        try:
            import cv2
            for name, img in rendered.items():
                cv2.imwrite(os.path.join(
                    self.record_dir,
                    f"{name}_{self._frame_idx:06d}.png"), img)
        except ImportError:
            from .io.pgm import save_pgm
            for name, img in rendered.items():
                g = img.mean(axis=2).astype(np.uint8) if img.ndim == 3 \
                    else img
                save_pgm(g, os.path.join(
                    self.record_dir,
                    f"{name}_{self._frame_idx:06d}.pgm"))

    def _pump_keys(self) -> bool:
        """Poll the window key queue; apply camera motion.  Returns False
        when the user quit (q / ESC)."""
        if self._display is not True:
            return True
        import cv2
        k = cv2.waitKey(1) & 0xFFFF
        if k in (ord("q"), 27):
            self.close()
            return False
        if k in _KEYMAP:
            self.cam.handle_key(_KEYMAP[k])
        elif 0 < k < 256:
            self.cam.handle_key(chr(k).lower())
        return True

    def close(self):
        if self._display:
            try:
                import cv2
                cv2.destroyAllWindows()
            except Exception:
                pass
        self._display = False
