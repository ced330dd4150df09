"""The plain reference of a darknet detector (YOLOv4, and any cfg of the
same sections): its cfg parser, its .weights reader and its forward pass in
float32 torch, one frame at a time, with the pre-processing and the decode
of the port's detector (stereovision_tpu_torch/models/yolo.py), which it
does not import.

  pre-processing  BGR -> RGB, cv2's bilinear resize to the cfg's size,
                  / 255 in NumPy float32;
  convolution     im2col (F.unfold) and a matmul, in bands of output rows
                  whose columns hold at most BAND_ELEMENTS floats;
  batch norm      unfolded, as the layer states it:
                  (conv - mean) / sqrt(var + 1e-5) * gamma + beta (the
                  port folds the scale into the weights and the shift into
                  a bias: the two differ in rounding only; eps is the
                  port's);
  activations     leaky 0.1, mish x * tanh(log(1 + exp x)), linear;
  max pool        darknet's: k - 1 of padding, (k - 1) // 2 before,
                  padded with -inf;
  upsample        nearest; route: channels joined (with groups, a slice);
                  shortcut: the sum of the previous and the referenced
                  layer;
  yolo            darknet's decode with scale_x_y: x = (sigmoid(tx) * s -
                  (s - 1) / 2 + column) / grid width, w = exp(tw) *
                  anchor / net width, objectness sigmoid(to), each class
                  sigmoid(tc) * objectness; rows in (grid row, grid column,
                  anchor) order, the heads one after another, as the
                  port's rows.

detections(rows, frame_hw, names) is the post-processing of the
reference's detector (detector.cpp:42-66) in plain NumPy: for each class in
turn, the rows whose score reaches 0.5, their boxes in whole pixels (the
float32 corner and size cut towards zero, as the int cv::Rect takes them),
then greedy suppression in falling score (ties in row order, as
cv::dnn::NMSBoxes sorts) of every box whose overlap with a kept one exceeds
0.4, the overlap compared in whole numbers (5 * intersection > 2 * union);
agrees(dets, rows, frame_hw, names) accepts equal scores in any order.

TF32 is off while it computes (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False).  With tf32=True it is the control
in the precision below float32: each matmul's operands rounded to TF32's
10-bit mantissa (to nearest, ties to even), TF32 on.  It imports nothing of
the port or of the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the most floats of one band's im2col columns
BAND_ELEMENTS = 1 << 26
BN_EPS = 1e-5
SCORE_THRESHOLD = 0.5
OVERLAP_THRESHOLD = (2, 5)      # 0.4 as a fraction


def parse_cfg(path: str) -> List[Dict[str, str]]:
    """A darknet .cfg as sections: {"type": name, key: value, ...}, the
    text after "#" dropped."""
    sections: List[Dict[str, str]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if line.startswith("["):
                sections.append({"type": line.strip("[]")})
            elif "=" in line and sections:
                k, v = line.split("=", 1)
                sections[-1][k.strip()] = v.strip()
    return sections


def _sources(l: Dict[str, str], i: int) -> List[int]:
    key = "layers" if l["type"] == "route" else "from"
    return [int(x) + (i if int(x) < 0 else 0) for x in l[key].split(",")]


def layer_shapes(sections) -> List[Tuple[int, int, int]]:
    """(channels, height, width) of each layer's output, from the [net]
    section's size."""
    net = sections[0]
    c, h, w = int(net.get("channels", 3)), int(net["height"]), \
        int(net["width"])
    out: List[Tuple[int, int, int]] = []
    for i, l in enumerate(sections[1:]):
        t = l["type"]
        if t == "convolutional":
            k, s = int(l["size"]), int(l["stride"])
            p = k // 2 if l.get("pad") == "1" else 0
            c, h, w = int(l["filters"]), (h + 2 * p - k) // s + 1, \
                (w + 2 * p - k) // s + 1
        elif t == "maxpool":
            k, s = int(l["size"]), int(l["stride"])
            h, w = (h + k - 1 - k) // s + 1, (w + k - 1 - k) // s + 1
        elif t == "upsample":
            h, w = h * int(l["stride"]), w * int(l["stride"])
        elif t == "route":
            src = _sources(l, i)
            c = sum(out[j][0] for j in src) // int(l.get("groups", 1))
            h, w = out[src[0]][1:]
        elif t not in ("shortcut", "yolo"):
            raise ValueError("layer %d: no reference for [%s]" % (i, t))
        out.append((c, h, w))
    return out


@contextlib.contextmanager
def _tf32(on: bool) -> Iterator[None]:
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = old


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even),
    as float32."""
    i = x.contiguous().view(torch.int32)
    keep = ((i >> 13) & 1) + 0xFFF
    return ((i + keep) & ~0x1FFF).view(torch.float32)


class Darknet:
    """A cfg and its .weights on a device: rows(frame) is the decoded
    detector output of one BGR frame."""

    def __init__(self, cfg_path: str, weights_path: str, device="cpu"):
        self.sections = parse_cfg(cfg_path)
        self.net, self.layers = self.sections[0], self.sections[1:]
        self.shapes = layer_shapes(self.sections)
        self.device = torch.device(device)
        self.params = self._read_weights(weights_path)

    def _read_weights(self, path: str) -> Dict[int, Dict[str, torch.Tensor]]:
        """Header (major, minor, revision int32; seen int64 from 0.2 on,
        else int32), then for each convolution in order [beta, gamma,
        mean, var] with batch norm, else [bias], then its (out, in, k, k)
        weights.  A file of another length raises ValueError."""
        with open(path, "rb") as f:
            major, minor, _ = np.fromfile(f, np.int32, 3)
            np.fromfile(f, np.int64 if major * 10 + minor >= 2 else np.int32,
                        1)
            data = np.fromfile(f, np.float32)
        pos, params = 0, {}
        c_in = int(self.net.get("channels", 3))
        for i, l in enumerate(self.layers):
            if l["type"] == "convolutional":
                n, k = int(l["filters"]), int(l["size"])
                names = (("beta", "gamma", "mean", "var")
                         if l.get("batch_normalize") == "1" else ("bias",))
                p = {}
                for name in names:
                    p[name] = data[pos:pos + n]
                    pos += n
                p["w"] = data[pos:pos + n * c_in * k * k].reshape(
                    n, c_in * k * k)
                pos += n * c_in * k * k
                params[i] = {name: torch.from_numpy(v.copy()).to(self.device)
                             for name, v in p.items()}
            c_in = self.shapes[i][0]
        if pos != data.size:
            raise ValueError("weights file %s holds %d floats; the cfg needs "
                             "%d" % (path, data.size, pos))
        return params

    def preprocess(self, frame_bgr: np.ndarray) -> torch.Tensor:
        import cv2
        size = (int(self.net["width"]), int(self.net["height"]))
        img = cv2.resize(np.ascontiguousarray(frame_bgr[..., ::-1]), size)
        x = img.astype(np.float32) / np.float32(255.0)
        return torch.from_numpy(np.ascontiguousarray(
            x.transpose(2, 0, 1))).to(self.device)

    def rows(self, frame_bgr: np.ndarray, tf32: bool = False) -> np.ndarray:
        """(rows, 5 + classes) float32 NumPy of one (H, W, 3) uint8 BGR
        frame."""
        with torch.no_grad(), _tf32(tf32):
            x = self.preprocess(frame_bgr)
            outs, heads = [], []
            for i, l in enumerate(self.layers):
                x = self._layer(i, l, x, outs, tf32)
                if l["type"] == "yolo":
                    heads.append(self._yolo(l, x))
                outs.append(x)
            return torch.cat(heads).cpu().numpy()

    def _layer(self, i, l, x, outs, tf32) -> torch.Tensor:
        t = l["type"]
        if t == "convolutional":
            x = self._conv(x, self.params[i], int(l["size"]),
                           int(l["stride"]), l.get("pad") == "1", tf32)
            act = l.get("activation", "logistic")
            if act == "leaky":
                return torch.where(x > 0, x, 0.1 * x)
            if act == "mish":
                return x * torch.tanh(torch.log1p(torch.exp(x)))
            if act == "linear":
                return x
            raise ValueError("layer %d: no reference for activation %r"
                             % (i, act))
        if t == "maxpool":
            k, s = int(l["size"]), int(l["stride"])
            c, h, w = self.shapes[i]
            pads = []
            for n_in, n_out in ((x.shape[2], w), (x.shape[1], h)):
                before = (k - 1) // 2
                pads += [before, (n_out - 1) * s + k - n_in - before]
            return F.max_pool2d(F.pad(x, pads, value=float("-inf"))[None],
                                k, s)[0]
        if t == "upsample":
            s = int(l["stride"])
            return x.repeat_interleave(s, 1).repeat_interleave(s, 2)
        if t == "route":
            x = torch.cat([outs[j] for j in _sources(l, i)])
            g = int(l.get("groups", 1))
            gid = int(l.get("group_id", 0))
            n = x.shape[0] // g
            return x[gid * n:(gid + 1) * n]
        if t == "shortcut":
            if l.get("activation", "linear") != "linear":
                raise ValueError("layer %d: no reference for a shortcut "
                                 "with activation" % i)
            return x + outs[_sources(l, i)[0]]
        if t == "yolo":
            return x
        raise ValueError("layer %d: no reference for [%s]" % (i, t))

    @staticmethod
    def _conv(x, p, k, s, pad, tf32) -> torch.Tensor:
        """(C, H, W) -> (F, H', W'): im2col in bands of output rows and a
        matmul, then batch norm or the bias."""
        c, h, w = x.shape
        q = k // 2 if pad else 0
        xp = F.pad(x, (q, q, q, q))
        ho, wo = (h + 2 * q - k) // s + 1, (w + 2 * q - k) // s + 1
        wm = _round_tf32(p["w"]) if tf32 else p["w"]
        out = x.new_empty((wm.shape[0], ho, wo))
        band = max(1, BAND_ELEMENTS // (c * k * k * wo))
        for r0 in range(0, ho, band):
            r1 = min(ho, r0 + band)
            cols = F.unfold(xp[None, :, r0 * s:(r1 - 1) * s + k], k,
                            stride=s)[0]
            if tf32:
                cols = _round_tf32(cols)
            out[:, r0:r1] = (wm @ cols).view(-1, r1 - r0, wo)
        if "bias" in p:
            return out + p["bias"][:, None, None]
        return ((out - p["mean"][:, None, None])
                / torch.sqrt(p["var"][:, None, None] + BN_EPS)
                * p["gamma"][:, None, None] + p["beta"][:, None, None])

    def _yolo(self, l, x) -> torch.Tensor:
        mask = [int(m) for m in l["mask"].split(",")]
        anchors = [float(a) for a in l["anchors"].split(",")]
        nc = int(l.get("classes", 80))
        sxy = float(l.get("scale_x_y", 1.0))
        _, gh, gw = x.shape
        # (anchor, 5 + classes, gh, gw) -> (gh, gw, anchor, 5 + classes)
        t = x.view(len(mask), 5 + nc, gh, gw).permute(2, 3, 0, 1)
        col = torch.arange(gw, dtype=torch.float32,
                           device=x.device)[None, :, None]
        row = torch.arange(gh, dtype=torch.float32,
                           device=x.device)[:, None, None]
        aw = torch.tensor([anchors[2 * m] for m in mask], device=x.device)
        ah = torch.tensor([anchors[2 * m + 1] for m in mask],
                          device=x.device)
        off = 0.5 * (sxy - 1.0)
        bx = (torch.sigmoid(t[..., 0]) * sxy - off + col) / gw
        by = (torch.sigmoid(t[..., 1]) * sxy - off + row) / gh
        bw = torch.exp(t[..., 2]) * aw / int(self.net["width"])
        bh = torch.exp(t[..., 3]) * ah / int(self.net["height"])
        obj = torch.sigmoid(t[..., 4])
        cls = torch.sigmoid(t[..., 5:]) * obj[..., None]
        return torch.cat([torch.stack([bx, by, bw, bh, obj], -1), cls],
                         -1).reshape(-1, 5 + nc)



def candidates(rows: np.ndarray, c: int, frame_hw, names,
               to_pixel=np.trunc) -> List[tuple]:
    """Class c's rows at or above the threshold, in row order, as
    (name, x, y, w, h, conf): the float32 corner and size in the frame's
    pixels, cut towards zero (to_pixel)."""
    h, w = (np.float32(v) for v in frame_hw)
    name = names[c] if c < len(names) else str(c)
    r = rows[rows[:, 5 + c] >= SCORE_THRESHOLD]
    return [(name, int(to_pixel(cx * w - bw * w / np.float32(2))),
             int(to_pixel(cy * h - bh * h / np.float32(2))),
             int(to_pixel(bw * w)), int(to_pixel(bh * h)), float(s))
            for (cx, cy, bw, bh), s in zip(r[:, :4], r[:, 5 + c])]


def detections(rows: np.ndarray, frame_hw, names,
               to_pixel=np.trunc) -> List[tuple]:
    """One frame's (rows, 5 + classes) float32 rows -> its detections as
    (name, x, y, w, h, conf) in the frame's pixels, class by class, each
    class's candidates taken in falling score, equal scores in row order,
    each kept unless a kept one overlaps it."""
    out: List[tuple] = []
    for c in range(rows.shape[1] - 5):
        kept: List[tuple] = []
        for d in sorted(candidates(rows, c, frame_hw, names, to_pixel),
                        key=lambda d: -d[5]):
            if not any(_suppresses(k, d) for k in kept):
                kept.append(d)
        out += kept
    return out


def agrees(dets: List[tuple], rows: np.ndarray, frame_hw, names) -> bool:
    """Whether dets are what detections() gives with the candidates of
    equal score taken in some order (NMSBoxes takes them in row order;
    NumPy's default sort, which the port shares with the JAX package, may
    swap them): class by class, the served run of the class's name holds
    distinct candidates in falling score, none overlapped by one served
    before it, and every candidate left out is overlapped by a served one of
    higher or equal score."""
    dets = [tuple(d) for d in dets]
    pos = 0
    for c in range(rows.shape[1] - 5):
        cands = candidates(rows, c, frame_hw, names)
        end = pos
        while end < len(dets) and cands and dets[end][0] == cands[0][0]:
            end += 1
        served, pos = dets[pos:end], end
        left = list(cands)
        for d in served:
            if d not in left:
                return False
            left.remove(d)
        if any(a[5] < b[5] for a, b in zip(served, served[1:])):
            return False
        for i, d in enumerate(served):
            if any(_suppresses(k, d) for k in served[:i]):
                return False
        for d in left:
            if not any(_suppresses(k, d) for k in served if k[5] >= d[5]):
                return False
    return pos == len(dets)


def _suppresses(a: tuple, b: tuple) -> bool:
    """Whether box a overlaps box b by more than the threshold, in whole
    numbers: (name, x, y, w, h, conf) each."""
    num, den = OVERLAP_THRESHOLD
    iw = min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1])
    ih = min(a[2] + a[4], b[2] + b[4]) - max(a[2], b[2])
    inter = max(iw, 0) * max(ih, 0)
    union = max(a[3], 0) * max(a[4], 0) + max(b[3], 0) * max(b[4], 0) \
        - inter
    return den * inter > num * union
