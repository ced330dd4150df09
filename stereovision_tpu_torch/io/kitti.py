"""KITTI-layout stereo sequence loading and dataset acquisition utilities.

Covers the reference's three data paths (stereo_vision/sv.py:241-331 and
imageLoop, src/serial_includes/main/stereo_vision.cpp:636-687):
  * raw-sync sequences:  <root>/image_02/data/NNNNNNNNNN.png + image_03
  * KITTI-2015 scene flow: <root>/testing/image_2/*.png + image_3
  * resumable HTTP download / zip extraction / git clone helpers for the
    --demo datasets.

A copy of stereovision_tpu/io/kitti.py that never imports the JAX package.
Where cv2 is missing, _imread reads with PIL and, where that is missing
too, with the PNG reader of io/png.py; _resize interpolates with the port's
own resize (ops/reproject.py) instead of jax.image.resize.
"""

from __future__ import annotations

import functools
import os
import os.path as osp
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.reproject import linear_taps, resize_linear
from .png import read_png

KITTI2015_URL = ("https://s3.eu-central-1.amazonaws.com/avg-kitti/"
                 "data_scene_flow.zip")
MINI_DATASET_REPO = "https://github.com/AdityaNG/Mini_Stereo_Dataset.git"


def _imread(path: str) -> Optional[np.ndarray]:
    try:
        import cv2
    except ImportError:
        pass
    else:
        return cv2.imread(path)
    try:
        from PIL import Image
    except ImportError:
        return read_png(path)
    img = np.asarray(Image.open(path))
    return img[..., ::-1] if img.ndim == 3 else img


@functools.lru_cache(maxsize=8)
def _shrink_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64 weights of jax.image.resize "linear" from n_in
    down to n_out samples: the triangle widened by n_in / n_out
    (antialiased), each row normalised to sum 1.  Made once a shape (a
    detector resizes every frame to one size) and only read."""
    scale = n_out / n_in
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None]
                                     - np.arange(n_in)[None, :]) * scale)
    return torch.from_numpy(w / w.sum(axis=1, keepdims=True))


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """x float32 resized along dim (-1 or -2) to n_out samples: upsampling
    through ops.reproject.resize_linear (jax.image.resize's own weights and
    order), shrinking through _shrink_weights in float64."""
    n_in = x.shape[dim]
    if n_out == n_in:
        return x
    if n_out > n_in:
        taps = linear_taps(n_in, n_out, x.device)
        return (resize_linear(x, cols=taps) if dim == -1
                else resize_linear(x, rows=taps))
    wm = _shrink_weights(n_in, n_out).to(x.device)
    y = torch.movedim(x.double(), dim, -1) @ wm.T
    return torch.movedim(y, -1, dim).float()


def resize_float(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """(..., H, W) float32 -> (..., h, w) float32, jax.image.resize's
    "linear" with no cast back, computed where x lies: the width first,
    then the height."""
    return _resize_axis(_resize_axis(x, w, -1), h, -2)


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    if img.shape[1] == w and img.shape[0] == h:
        return img
    try:
        import cv2
    except ImportError:
        x = torch.movedim(torch.as_tensor(img, dtype=torch.float32)
                          .reshape(img.shape[:2] + (-1,)), -1, 0)
        out = torch.movedim(resize_float(x, w, h), 0, -1)
        return out.reshape((h, w) + img.shape[2:]).numpy().astype(img.dtype)
    return cv2.resize(img, (w, h))


class KittiRawSequence:
    """<root>/image_02/data/%010d.png stereo sequence (kitti_mini layout)."""

    def __init__(self, root: str, width: Optional[int] = None,
                 height: Optional[int] = None):
        self.root = root
        self.left_dir = osp.join(root, "image_02", "data")
        self.right_dir = osp.join(root, "image_03", "data")
        self.files = sorted(f for f in os.listdir(self.left_dir)
                            if f.endswith(".png"))
        self.width, self.height = width, height

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        l = _imread(osp.join(self.left_dir, self.files[i]))
        r = _imread(osp.join(self.right_dir, self.files[i]))
        if self.width:
            l = _resize(l, self.width, self.height)
            r = _resize(r, self.width, self.height)
        return l, r

    def frames(self, loop: bool = False
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            for i in range(len(self)):
                yield self[i]
            if not loop:
                return


class Kitti2015Scenes:
    """KITTI-2015 scene-flow layout: testing/image_2 + image_3."""

    def __init__(self, root: str, split: str = "testing",
                 width: Optional[int] = None, height: Optional[int] = None):
        self.left_dir = osp.join(root, split, "image_2")
        self.right_dir = osp.join(root, split, "image_3")
        self.files = sorted(os.listdir(self.left_dir))
        self.width, self.height = width, height

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        l = _imread(osp.join(self.left_dir, self.files[i]))
        r = _imread(osp.join(self.right_dir, self.files[i]))
        if self.width:
            l = _resize(l, self.width, self.height)
            r = _resize(r, self.width, self.height)
        return l, r

    def frames(self, loop: bool = False):
        while True:
            for i in range(len(self)):
                yield self[i]
            if not loop:
                return


# ---------------------------------------------------------------------------
# acquisition (reference sv.py:22-85)

def download_file(url: str, dest_path: str, show_progress: bool = True):
    """Resumable HTTP download (Range header, reference sv.py:47-85)."""
    import requests
    req = requests.get(url, stream=True)
    req.raise_for_status()
    total = int(req.headers.get("content-length", 0))
    start = 0
    if osp.exists(dest_path):
        start = os.stat(dest_path).st_size
        if start == total:
            return dest_path
        if start > total:
            os.remove(dest_path)
            start = 0
        else:
            req = requests.get(url, headers={"Range": f"bytes={start}-"},
                               stream=True, allow_redirects=True)
    with open(dest_path, "ab") as f:
        for chunk in req.iter_content(1 << 16):
            f.write(chunk)
    return dest_path


def unzip_file(src_path: str, dest_dir: str):
    os.makedirs(dest_dir, exist_ok=True)
    with zipfile.ZipFile(src_path) as z:
        z.extractall(dest_dir)


def clone_repo(url: str, dest: str):
    import subprocess
    if not osp.isdir(dest):
        subprocess.run(["git", "clone", url, dest], check=False)
    else:
        subprocess.run(["git", "pull"], cwd=dest, check=False)
