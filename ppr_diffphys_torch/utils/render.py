"""Offscreen rendering through the repository's native C++ rasterizer
(``csrc/rasterizer.cpp`` at the repository root), counterpart of
``ppr_diffphys_tpu/utils/render.py``.

A dependency-free software pipeline in place of the reference's
pyrender/EGL wrapper (diffphys/pyrender_wrapper.py): Python sets up cameras
and geometry, the shared library does z-buffered smooth-shaded scan
conversion. The library is built with g++ on first use into
``ppr_diffphys_torch/build/`` (listed in ``.gitignore``), never into
``csrc/``, under a file name keyed by the source's hash, the flags and the
host CPU (``-march=native`` code runs only on the CPU it was built for). The
flags are the JAX package's own: other flags change FMA contraction, and the
pixels then stop matching.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "csrc" / "rasterizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    key = SRC.read_bytes() + " ".join(GXX_FLAGS).encode() + _cpu_model().encode()
    return BUILD_DIR / ("librasterizer-%s.so" % hashlib.sha256(key).hexdigest()[:16])


def _load_lib():
    """The rasterizer library (built on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(".%d.tmp" % os.getpid())
            subprocess.check_call(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)])
            os.replace(tmp, so)  # atomic: a half-written library is never loaded
        lib = ctypes.CDLL(str(so))
        lib.rasterize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.rasterize.restype = None
        _lib = lib
        return lib


def _cptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rotvec_matrix(rv):
    from scipy.spatial.transform import Rotation as R

    return R.from_rotvec(rv).as_matrix()


class SoftwareRenderer:
    """Camera and raster state (stand-in for PyRenderWrapper, reference
    pyrender_wrapper.py:22-160). ``scene_to_cam`` is CV-convention
    (+z forward, y down), what the rasterizer consumes."""

    def __init__(self, height=256, width=256):
        self.H, self.W = int(height), int(width)
        fl = max(self.H, self.W)
        self.K = np.array([fl, fl, self.W / 2, self.H / 2], np.float32)
        self.scene_to_cam = np.eye(4, dtype=np.float32)
        # light travel direction in WORLD coordinates (the reference's
        # DirectionalLight lives in the scene, pyrender_wrapper.py:30), rotated
        # into camera space per render(); default: tilted overhead light for
        # the y-up sim world
        self.light_dir = np.array([0.3, -0.8, 0.5], np.float32)
        self.light_dir /= np.linalg.norm(self.light_dir)
        self.set_camera_default()

    # -- camera presets -------------------------------------------------
    def set_camera(self, scene_to_cam):
        self.scene_to_cam = np.asarray(scene_to_cam, np.float32)

    def set_intrinsics(self, k4):
        self.K = np.asarray(k4, np.float32)

    def set_camera_default(self):
        """The view the reference uses when no camera is given (vis.py:98-108):
        rotate -5pi/6 about x then -pi/2 about y, t=(0,0,3)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _rotvec_matrix([-5 * np.pi / 6, 0, 0]) @ _rotvec_matrix([0, -np.pi / 2, 0])
        m[:3, 3] = [0, 0, 3.0]
        self.scene_to_cam = m

    def set_camera_bev(self, depth, gl=False):
        """Reference pyrender_wrapper.py:47-56 (pre-flip matrix)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _rotvec_matrix([-np.pi / 2, 0, 0] if gl else [np.pi / 2, 0, 0])
        m[2, 3] = depth
        self.scene_to_cam = m

    def set_camera_frontal(self, depth, gl=False, delta=0.0):
        """Reference pyrender_wrapper.py:58-67 (pre-flip matrix)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _rotvec_matrix(
            [np.pi + np.pi / 180, delta, 0] if gl else [np.pi / 180, delta, 0])
        m[2, 3] = depth
        self.scene_to_cam = m

    def get_cam_to_scene(self):
        """Inverse of scene_to_cam (reference pyrender_wrapper.py:93-97)."""
        out = np.eye(4, dtype=np.float32)
        R = self.scene_to_cam[:3, :3]
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ self.scene_to_cam[:3, 3]
        return out

    def set_light_topdown(self, gl=False):
        """Top-down directional light fixed in WORLD space (reference
        pyrender_wrapper.py:73-79): travel (0,-1,0) in y-up worlds (gl=True),
        (0,1,0) in y-down worlds."""
        self.light_dir = np.array([0.0, -1.0, 0.0] if gl else [0.0, 1.0, 0.0], np.float32)

    def align_light_to_camera(self):
        """Light along the camera's viewing axis (reference
        pyrender_wrapper.py:81-82): world travel direction R^T (0,0,1)."""
        self.light_dir = np.ascontiguousarray(
            self.scene_to_cam[:3, :3].T @ np.array([0, 0, 1.0], np.float32))

    # -- render ---------------------------------------------------------
    def render(self, verts, faces, colors, background=255):
        """verts (V,3) world, faces (F,3), colors (V,3) uint8 -> (H,W,3) uint8."""
        lib = _load_lib()
        v = np.ascontiguousarray(verts, np.float32)
        vc = v @ self.scene_to_cam[:3, :3].T + self.scene_to_cam[:3, 3][None]
        vc = np.ascontiguousarray(vc, np.float32)
        # the rasterizer shades with camera-space normals
        l_cam = self.scene_to_cam[:3, :3] @ self.light_dir
        l_cam = np.ascontiguousarray(l_cam / max(np.linalg.norm(l_cam), 1e-12), np.float32)
        f = np.ascontiguousarray(faces, np.int32)
        c = np.ascontiguousarray(colors, np.uint8)
        if len(c) != len(vc) or (len(f) and (f.min() < 0 or f.max() >= len(vc))):
            raise ValueError("render: %d colors and face indices in [%s, %s] for %d vertices"
                             % (len(c), f.min() if len(f) else "-",
                                f.max() if len(f) else "-", len(vc)))
        img = np.full((self.H, self.W, 3), background, np.uint8)
        lib.rasterize(
            _cptr(vc, ctypes.c_float), len(vc),
            _cptr(f, ctypes.c_int32), len(f),
            _cptr(c, ctypes.c_uint8),
            _cptr(self.K, ctypes.c_float),
            _cptr(l_cam, ctypes.c_float),
            self.H, self.W,
            _cptr(img, ctypes.c_uint8),
        )
        return img

    def render_default_view(self, verts, faces, colors):
        self.set_camera_default()
        return self.render(verts, faces, colors)

    def delete(self):
        pass
