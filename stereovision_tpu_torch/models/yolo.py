"""Darknet-family object detector (YOLOv4-tiny and YOLOv4) in PyTorch
(counterpart of stereovision_tpu/models/yolo.py).

The reference's OpenCV-DNN darknet wrapper
(src/common_includes/yolo/{yolo.hpp,detector.cpp}) as a generic darknet
cfg parser, a .weights loader that folds batch norm into the convolutions
(in NumPy float32, as the JAX package does) and an NCHW forward pass, with
the reference's pre- and post-processing: 608x608 bilinear resize,
BGR->RGB, /255 (detector.cpp:31), per-class score threshold 0.5 and
per-class greedy NMS at IoU 0.4 on integer boxes (detector.cpp:42-66).

The sections implemented are [convolutional] (leaky, mish or linear),
[maxpool], [upsample], [route] (with groups), [shortcut] (linear) and
[yolo]; a cfg with any other section type or activation raises ValueError
when the model is built.  Built in: yolov4-tiny and YOLOv4 (CSPDarknet53,
SPP, PANet, three heads), both also packaged under data/yolo/.

The convolutions are F.conv2d, run with cuDNN's TF32 off so that the card
computes them in float32 as the JAX package does.  Thresholding and NMS run
on the host in NumPy, the same code as the JAX package's.  The detector
runs on the card unless device="cpu".

Spans (profiling.py, while tracing is on): rows() records
"svtt.detect.preprocess" (BGR->RGB, the resize, the upload and /255),
"svtt.detect.forward" (counts convs, shortcuts, routes) and
"svtt.detect.fetch" (count bytes); decode() records "svtt.detect.decode"
(counts candidates, the rows at or above the threshold in any class, and
detections).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling as P
from ..device import resolve_device
from ..io.kitti import resize_float
from ..transfer import fetch, upload
from .bayesian import Detection

CONFIDENCE_THRESHOLD = 0.5
NMS_THRESHOLD = 0.4

_BOX_COLORS = [(0, 255, 255), (255, 255, 0), (0, 255, 0), (255, 0, 0)]

COCO_CLASSES = (
    "person bicycle car motorbike aeroplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog "
    "horse sheep cow elephant bear zebra giraffe backpack umbrella handbag "
    "tie suitcase frisbee skis snowboard sports_ball kite baseball_bat "
    "baseball_glove skateboard surfboard tennis_racket bottle wine_glass "
    "cup fork knife spoon bowl banana apple sandwich orange broccoli "
    "carrot hot_dog pizza donut cake chair sofa pottedplant bed "
    "diningtable toilet tvmonitor laptop mouse remote keyboard cell_phone "
    "microwave oven toaster sink refrigerator book clock vase scissors "
    "teddy_bear hair_drier toothbrush").split()

DATA_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "data",
                    "yolo")

# what forward implements: section types after [net], and activations of
# [convolutional] (darknet's default is logistic); a [shortcut] only linear
LAYER_TYPES = ("convolutional", "maxpool", "upsample", "route", "shortcut",
               "yolo")
ACTIVATIONS = ("leaky", "mish", "linear")


# ---------------------------------------------------------------------------
# cfg parsing

def parse_darknet_cfg(path: str) -> List[Dict]:
    sections: List[Dict] = []
    cur: Optional[Dict] = None
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            if line.startswith("["):
                cur = {"type": line.strip("[]")}
                sections.append(cur)
            elif "=" in line and cur is not None:
                k, v = line.split("=", 1)
                cur[k.strip()] = v.strip()
    return sections


def builtin_yolov4_tiny_cfg() -> List[Dict]:
    """The yolov4-tiny architecture as cfg sections (standard public
    topology; used when no cfg file is supplied)."""
    def conv(f, s=1, k=3, act="leaky", bn=1):
        return {"type": "convolutional", "filters": str(f), "size": str(k),
                "stride": str(s), "pad": "1", "activation": act,
                **({"batch_normalize": "1"} if bn else {})}

    def route(layers, groups=None, gid=None):
        d = {"type": "route", "layers": ",".join(str(x) for x in layers)}
        if groups is not None:
            d["groups"] = str(groups)
            d["group_id"] = str(gid)
        return d

    anchors = "10,14, 23,27, 37,58, 81,82, 135,169, 344,319"

    def yolo(mask):
        return {"type": "yolo", "mask": mask, "anchors": anchors,
                "classes": "80", "num": "6", "scale_x_y": "1.05"}

    mp = {"type": "maxpool", "size": "2", "stride": "2"}
    net = [{"type": "net", "width": "608", "height": "608", "channels": "3"}]

    def csp_block(f):
        return [conv(f), route([-1], 2, 1), conv(f // 2), conv(f // 2),
                route([-1, -2]), conv(f, k=1), route([-6, -1]), mp]

    return (net
            + [conv(32, 2), conv(64, 2)]
            + csp_block(64)[:-1] + [mp]
            + csp_block(128)[:-1] + [mp]
            + csp_block(256)[:-1] + [mp]
            + [conv(512), conv(256, k=1), conv(512),
               conv(255, k=1, act="linear", bn=0), yolo("3,4,5"),
               route([-4]), conv(128, k=1),
               {"type": "upsample", "stride": "2"},
               route([-1, 23]), conv(256),
               conv(255, k=1, act="linear", bn=0), yolo("1,2,3")])


YOLOV4_ANCHORS = "12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, " \
    "192,243, 459,401"


def builtin_yolov4_cfg() -> List[Dict]:
    """YOLOv4 (Bochkovskiy, Wang and Liao, arXiv:2004.10934) as cfg
    sections: darknet's cfg/yolov4.cfg, its 162 layers at 608x608 without
    the training keys.  CSPDarknet53 with Mish (layers 0-104), SPP
    (105-113), PANet (114-136 up, 140-159 down) with leaky, and three heads
    (yolo layers 139, 150, 161 on grids of stride 8, 16, 32)."""
    def conv(f, k=1, s=1, act="leaky"):
        return {"type": "convolutional", "batch_normalize": "1",
                "filters": str(f), "size": str(k), "stride": str(s),
                "pad": "1", "activation": act}

    def route(*layers):
        return {"type": "route", "layers": ",".join(str(x) for x in layers)}

    def mish(f, k=1, s=1):
        return conv(f, k, s, "mish")

    shortcut = {"type": "shortcut", "from": "-3", "activation": "linear"}

    def csp(c, n, first=False):
        """A CSP stage: conv 2c 3x3/2, a split conv c and a route -2 conv
        c, n residual blocks, conv c, the route of the last layer and the
        split conv, conv 2c (the first stage: 64 wide throughout)."""
        w = 2 * c if first else c
        block = [mish(c), mish(w, 3), shortcut]
        return ([mish(2 * c, 3, 2), mish(w), route(-2), mish(w)]
                + block * n
                + [mish(w), route(-1, -(3 * n + 4)), mish(2 * c)])

    def head(mask, sxy):
        return [{"type": "convolutional", "size": "1", "stride": "1",
                 "pad": "1", "filters": "255", "activation": "linear"},
                {"type": "yolo", "mask": mask, "anchors": YOLOV4_ANCHORS,
                 "classes": "80", "num": "9", "scale_x_y": sxy}]

    def five(c):
        return [conv(c), conv(2 * c, 3), conv(c), conv(2 * c, 3), conv(c)]

    maxpool = [{"type": "maxpool", "stride": "1", "size": str(k)}
               for k in (5, 9, 13)]
    net = [{"type": "net", "width": "608", "height": "608", "channels": "3"}]
    backbone = ([mish(32, 3)] + csp(32, 1, first=True) + csp(64, 2)
                + csp(128, 8) + csp(256, 8) + csp(512, 4))
    spp = ([conv(512), conv(1024, 3), conv(512), maxpool[0], route(-2),
            maxpool[1], route(-4), maxpool[2], route(-1, -3, -5, -6)])
    up = ([conv(512), conv(1024, 3), conv(512), conv(256),
           {"type": "upsample", "stride": "2"}, route(85), conv(256),
           route(-1, -3)] + five(256)
          + [conv(128), {"type": "upsample", "stride": "2"}, route(54),
             conv(128), route(-1, -3)] + five(128))
    down = ([conv(256, 3)] + head("0,1,2", "1.2")
            + [route(-4), conv(256, 3, 2), route(-1, -16)] + five(256)
            + [conv(512, 3)] + head("3,4,5", "1.1")
            + [route(-4), conv(512, 3, 2), route(-1, -37)] + five(512)
            + [conv(1024, 3)] + head("6,7,8", "1.05"))
    return [dict(sec) for sec in net + backbone + spp + up + down]


def write_darknet_cfg(path: str, sections: List[Dict]) -> None:
    """Cfg sections as a darknet .cfg file that parse_darknet_cfg reads
    back to the same sections."""
    with open(path, "w") as f:
        f.write("\n".join("[%s]\n" % sec["type"] + "".join(
            "%s=%s\n" % kv for kv in sec.items() if kv[0] != "type")
            for sec in sections))


def _refs(l: Dict, i: int) -> List[int]:
    """The absolute indices of a [route]'s layers or a [shortcut]'s
    from."""
    refs = [int(x) for x in l["layers" if l["type"] == "route"
                             else "from"].split(",")]
    return [r if r >= 0 else i + r for r in refs]


def _check_layers(layers: List[Dict], chans: List[int]) -> None:
    """ValueError for a section or an activation that forward does not
    implement, or a shortcut of layers with different channels."""
    for i, l in enumerate(layers):
        t = l["type"]
        if t not in LAYER_TYPES:
            raise ValueError("layer %d: darknet section [%s] is not "
                             "implemented" % (i, t))
        act = l.get("activation", "logistic" if t == "convolutional"
                    else "linear")
        if (t == "convolutional" and act not in ACTIVATIONS
                or t == "shortcut" and act != "linear"):
            raise ValueError("layer %d: activation %r of [%s] is not "
                             "implemented" % (i, act, t))
        if t == "convolutional" and int(l.get("groups", 1)) != 1:
            raise ValueError("layer %d: grouped [convolutional] is not "
                             "implemented" % i)
        if t == "shortcut":
            src, = _refs(l, i)
            if "weights_type" in l or chans[src] != chans[i - 1]:
                raise ValueError("layer %d: [shortcut] of layers %d and %d "
                                 "(%d, %d channels, weights %s) is not "
                                 "implemented" % (i, src, i - 1, chans[src],
                                                  chans[i - 1],
                                                  l.get("weights_type")))


# ---------------------------------------------------------------------------
# model

class YoloV4Tiny(nn.Module):
    """Darknet detector: parse cfg, hold the folded conv parameters (buffers
    w<i> OIHW and b<i> for conv layer i), forward on the model's device."""

    def __init__(self, sections: List[Dict],
                 class_names: Sequence[str] = COCO_CLASSES,
                 seed: int = 0, device: Optional[str] = None):
        super().__init__()
        self.net_cfg = sections[0]
        self.layers = sections[1:]
        self.size = int(self.net_cfg.get("width", 608))
        self.class_names = list(class_names)
        _check_layers(self.layers, self._layer_channels())
        types = [l["type"] for l in self.layers]
        self.counts = {"convs": types.count("convolutional"),
                       "shortcuts": types.count("shortcut"),
                       "routes": types.count("route")}
        self._init_random(seed, resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    # -- construction --------------------------------------------------------

    @classmethod
    def from_files(cls, cfg_path: Optional[str] = None,
                   weights_path: Optional[str] = None,
                   classes_path: Optional[str] = None,
                   device: Optional[str] = None) -> "YoloV4Tiny":
        sections = (parse_darknet_cfg(cfg_path) if cfg_path
                    else builtin_yolov4_tiny_cfg())
        if classes_path is None:
            # the packaged class list (the names the reference prints);
            # COCO_CLASSES is the fallback
            pkg = osp.join(DATA_DIR, "classes.txt")
            classes_path = pkg if osp.exists(pkg) else None
        names = COCO_CLASSES
        if classes_path:
            with open(classes_path) as f:
                names = [l.strip() for l in f if l.strip()]
        model = cls(sections, names, device=device)
        if weights_path:
            model.load_darknet_weights(weights_path)
        return model

    def _layer_channels(self) -> List[int]:
        chans = []
        c = int(self.net_cfg.get("channels", 3))
        for i, l in enumerate(self.layers):
            t = l["type"]
            if t == "convolutional":
                c = int(l["filters"])
            elif t == "route":
                c = sum(chans[r] for r in _refs(l, i))
                if "groups" in l:
                    c //= int(l["groups"])
            # maxpool/upsample/shortcut/yolo keep channels
            chans.append(c)
        return chans

    def _init_random(self, seed: int, device: torch.device):
        """The JAX package's draws in its order (HWIO normals from
        default_rng(seed)), stored OIHW: the same seed gives the same
        parameters bit for bit."""
        rng = np.random.default_rng(seed)
        chans = self._layer_channels()
        c_in = int(self.net_cfg.get("channels", 3))
        for i, l in enumerate(self.layers):
            if l["type"] == "convolutional":
                k = int(l["size"])
                f = int(l["filters"])
                scale = 1.0 / np.sqrt(k * k * c_in)
                w = rng.normal(0, scale, (k, k, c_in, f)).astype(np.float32)
                self.register_buffer(
                    "w%d" % i, torch.from_numpy(w.transpose(3, 2, 0, 1)
                                                .copy()).to(device))
                self.register_buffer("b%d" % i, torch.zeros(f,
                                                            device=device))
            if l["type"] == "route":
                c_in = sum(chans[r] for r in _refs(l, i))
                if "groups" in l:
                    c_in //= int(l["groups"])
            else:
                c_in = chans[i]

    def load_darknet_weights(self, path: str):
        """Darknet .weights binary: 3x int32 version + int64 seen counter,
        then per conv layer [bn_b, bn_g, bn_mean, bn_var] or [bias], then
        OIHW conv weights.  Batch norm is folded into (w, b) here, in NumPy
        float32.  A file whose size does not fit the cfg raises ValueError
        and leaves the parameters as they were."""
        with open(path, "rb") as f:
            major, minor, _rev = np.fromfile(f, np.int32, 3)
            if major * 10 + minor >= 2:
                np.fromfile(f, np.int64, 1)
            else:
                np.fromfile(f, np.int32, 1)
            buf = np.fromfile(f, np.float32)
        pos = 0

        def take(n):
            nonlocal pos
            out = buf[pos:pos + n]
            pos += n
            return out

        folded = {}
        for i, l in enumerate(self.layers):
            if l["type"] != "convolutional":
                continue
            f, c_in, k, _ = getattr(self, "w%d" % i).shape
            if l.get("batch_normalize") == "1":
                bn_b = take(f)
                bn_g = take(f)
                bn_m = take(f)
                bn_v = take(f)
                w = take(f * c_in * k * k).reshape(f, c_in, k, k)
                scale = bn_g / np.sqrt(bn_v + 1e-5)
                w = w * scale[:, None, None, None]
                b = bn_b - bn_m * scale
            else:
                b = take(f)
                w = take(f * c_in * k * k).reshape(f, c_in, k, k)
            folded[i] = (w.astype(np.float32), b.astype(np.float32))
        if pos != len(buf):
            raise ValueError(
                f"weights file mismatch: consumed {pos} of {len(buf)}")
        for i, (w, b) in folded.items():
            getattr(self, "w%d" % i).copy_(torch.from_numpy(w))
            getattr(self, "b%d" % i).copy_(torch.from_numpy(b))

    # -- forward -------------------------------------------------------------

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (N, 3, S, S) float32 in [0,1] on the model's device.  Returns
        the decoded detections of each yolo head: (N, rows, 5 + classes),
        normalized cxcywh, rows in (gh, gw, anchor) order."""
        outputs: List[torch.Tensor] = []
        acts: List[torch.Tensor] = []
        for i, l in enumerate(self.layers):
            t = l["type"]
            if t == "convolutional":
                pad = (int(l["size"]) // 2) if l.get("pad") == "1" else 0
                s = int(l["stride"])
                # the bias after the sum, as the JAX package adds it
                x = F.conv2d(x, getattr(self, "w%d" % i), None, s, pad)
                x = x + getattr(self, "b%d" % i)[:, None, None]
                act = l["activation"]
                if act == "leaky":
                    x = torch.where(x > 0, x, 0.1 * x)
                elif act == "mish":
                    # jax.nn.softplus is logaddexp(x, 0); F.softplus
                    # switches to x above its threshold
                    x = x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))
            elif t == "maxpool":
                x = _maxpool_same(x, int(l["size"]), int(l["stride"]))
            elif t == "upsample":
                s = int(l["stride"])
                x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            elif t == "shortcut":
                x = x + acts[_refs(l, i)[0]]
            elif t == "route":
                parts = [acts[r] for r in _refs(l, i)]
                x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
                if "groups" in l:
                    g = int(l["groups"])
                    gid = int(l["group_id"])
                    cs = x.shape[1] // g
                    x = x[:, gid * cs:(gid + 1) * cs]
            elif t == "yolo":
                outputs.append(self._decode_yolo(x, l))
            acts.append(x)
        return outputs

    def _decode_yolo(self, x: torch.Tensor, l: Dict) -> torch.Tensor:
        n, _, gh, gw = x.shape
        anchors = [float(a) for a in l["anchors"].replace(" ", "").split(",")]
        anchors = np.array(anchors).reshape(-1, 2)
        mask = [int(m) for m in l["mask"].split(",")]
        na = len(mask)
        nc = int(l.get("classes", 80))
        sxy = float(l.get("scale_x_y", 1.0))
        # NHWC before the split of the channels into (anchor, 5 + nc): the
        # JAX package's layout, and its (gh, gw, anchor) row order
        x = x.permute(0, 2, 3, 1).reshape(n, gh, gw, na, 5 + nc)
        dev = x.device
        cx = torch.arange(gw, dtype=torch.float32, device=dev)[None, :]
        cy = torch.arange(gh, dtype=torch.float32, device=dev)[:, None]
        txy = torch.sigmoid(x[..., 0:2]) * sxy - 0.5 * (sxy - 1.0)
        bx = (txy[..., 0] + cx[None, :, :, None]) / gw
        by = (txy[..., 1] + cy[None, :, :, None]) / gh
        aw = torch.tensor([anchors[m][0] for m in mask], dtype=torch.float32,
                          device=dev)
        ah = torch.tensor([anchors[m][1] for m in mask], dtype=torch.float32,
                          device=dev)
        bw = torch.exp(x[..., 2]) * aw / self.size
        bh = torch.exp(x[..., 3]) * ah / self.size
        obj = torch.sigmoid(x[..., 4])
        cls = torch.sigmoid(x[..., 5:]) * obj[..., None]
        flat = torch.cat(
            [torch.stack([bx, by, bw, bh, obj], dim=-1), cls], dim=-1)
        return flat.reshape(n, -1, 5 + nc)

    # -- public API ----------------------------------------------------------

    def detect(self, frame_bgr: np.ndarray,
               conf_threshold: float = CONFIDENCE_THRESHOLD,
               nms_threshold: float = NMS_THRESHOLD) -> List[Detection]:
        """frame_bgr: (H, W, 3) uint8.  Returns Detection list in frame
        pixel coordinates (reference processYOLO semantics)."""
        return self.detect_batch([frame_bgr], conf_threshold,
                                 nms_threshold)[0]

    def rows(self, frames_bgr) -> np.ndarray:
        """The decoded rows of a list of frames, one forward and one host
        fetch for the list: (n, rows, 5 + classes) float32 NumPy."""
        dev = self.device
        with P.span("svtt.detect.preprocess"):
            x = torch.stack([
                _resize_bilinear(np.ascontiguousarray(f[..., ::-1]),
                                 self.size, self.size, dev)
                for f in frames_bgr])
            # a divisor on the device: CUDA divides by a host scalar
            # through its reciprocal, which is not the JAX package's
            # rounding
            x = (x / torch.full((), 255.0, device=dev)).permute(0, 3, 1, 2)
            x = x.contiguous()
        with P.span("svtt.detect.forward", **self.counts), torch.no_grad(), \
                torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out = torch.cat(self(x), dim=1)
        with P.span("svtt.detect.fetch") as sp:
            rows = fetch(out)
            sp.add(bytes=rows.nbytes)
        return rows

    def detect_batch(self, frames_bgr,
                     conf_threshold: float = CONFIDENCE_THRESHOLD,
                     nms_threshold: float = NMS_THRESHOLD
                     ) -> List[List[Detection]]:
        """Detect on a whole list of frames with one forward and one host
        fetch.  Per-frame results are identical to detect() on each
        frame."""
        return self.decode(self.rows(frames_bgr),
                           [f.shape[:2] for f in frames_bgr],
                           conf_threshold, nms_threshold)

    def decode(self, rows_all: np.ndarray, frame_hws,
               conf_threshold: float = CONFIDENCE_THRESHOLD,
               nms_threshold: float = NMS_THRESHOLD
               ) -> List[List[Detection]]:
        """rows() of a list of frames -> each frame's detections in its
        pixel coordinates; frame_hws: each frame's (H, W)."""
        with P.span("svtt.detect.decode") as sp:
            dets = [self._rows_to_dets(rows, hw, conf_threshold,
                                       nms_threshold)
                    for rows, hw in zip(rows_all, frame_hws)]
            if P.recording():
                sp.add(candidates=int((rows_all[..., 5:] >= conf_threshold)
                                      .any(axis=-1).sum()),
                       detections=sum(len(d) for d in dets))
        return dets

    def _rows_to_dets(self, rows, frame_hw, conf_threshold,
                      nms_threshold) -> List[Detection]:
        fh, fw = frame_hw
        dets: List[Detection] = []
        nc = rows.shape[1] - 5
        for c in range(nc):
            scores = rows[:, 5 + c]
            keep = scores >= conf_threshold
            if not keep.any():
                continue
            r = rows[keep]
            s = scores[keep]
            # integer boxes BEFORE NMS: the reference constructs int
            # cv::Rects (C-style truncation) and runs NMSBoxes on those
            # (detector.cpp:50-54,66) — float boxes flip near-threshold
            # suppression decisions
            boxes = np.trunc(np.stack([
                r[:, 0] * fw - r[:, 2] * fw / 2,
                r[:, 1] * fh - r[:, 3] * fh / 2,
                r[:, 2] * fw, r[:, 3] * fh], axis=1))
            for idx in _nms(boxes, s, nms_threshold):
                color = _BOX_COLORS[c % len(_BOX_COLORS)]
                name = (self.class_names[c] if c < len(self.class_names)
                        else str(c))
                dets.append(Detection(
                    name=name, x=int(boxes[idx, 0]), y=int(boxes[idx, 1]),
                    w=int(boxes[idx, 2]), h=int(boxes[idx, 3]),
                    conf=float(s[idx]),
                    g=color[0] / 255.0, b=color[1] / 255.0,
                    r=color[2] / 255.0))
        return dets


def decision_margins(rows_a: np.ndarray, rows_b: np.ndarray, frame_hw,
                     conf_threshold: float = CONFIDENCE_THRESHOLD
                     ) -> Dict[str, float]:
    """How far the decisions of _rows_to_dets on one frame's rows_a lie from
    flipping, each over how far rows_b moves it (two forwards of the same
    frame: another device, another package).  Where all three are above 1,
    both row sets give the same candidates, integer boxes and score order,
    so the same detections but for their conf:

      scores  min over class scores  |s_a - thr| / |s_a - s_b|
      boxes   min over candidates' box coordinates, distance of the float
              coordinate on a from the nearest integer / its move
      order   min over neighbours in a class's candidates sorted on a,
              their gap on a / the sum of their moves
    (0 / 0 counts as inf: nothing moved)."""
    def ratio(dist, move):
        dist, move = np.broadcast_arrays(np.abs(dist), np.abs(move))
        out = np.full(dist.shape, np.inf)
        np.divide(dist, move, out=out, where=move > 0)
        out[(move > 0) & (dist == 0)] = 0.0
        return float(out.min()) if out.size else float("inf")

    fh, fw = frame_hw
    sa, sb = rows_a[:, 5:], rows_b[:, 5:]
    out = {"scores": ratio(sa - conf_threshold, sa - sb),
           "boxes": float("inf"), "order": float("inf")}

    def boxes(r):
        return np.stack([r[:, 0] * fw - r[:, 2] * fw / 2,
                         r[:, 1] * fh - r[:, 3] * fh / 2,
                         r[:, 2] * fw, r[:, 3] * fh], axis=1)

    for c in range(sa.shape[1]):
        keep = sa[:, c] >= conf_threshold
        if not keep.any():
            continue
        ba, bb = boxes(rows_a[keep]), boxes(rows_b[keep])
        out["boxes"] = min(out["boxes"], ratio(ba - np.round(ba), ba - bb))
        order = np.argsort(-sa[keep, c], kind="stable")
        s, d = sa[keep, c][order], (sa[keep, c] - sb[keep, c])[order]
        out["order"] = min(out["order"], ratio(s[:-1] - s[1:],
                                               np.abs(d[:-1]) + np.abs(d[1:])))
    return out


def _maxpool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """reduce_window max with "SAME" padding: each spatial axis padded with
    -inf by total = max((ceil(n/s) - 1) * s + k - n, 0), total // 2 before
    and the rest after (XLA's split, not max_pool2d's symmetric one)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


def _resize_bilinear(img: np.ndarray, h: int, w: int,
                     device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 -> (h, w, 3) float32 on device: cv2.resize where cv2
    exists, else jax.image.resize's "linear" with no cast back to uint8 (the
    JAX package's fallback), computed on the device."""
    try:
        import cv2
    except ImportError:
        x = torch.movedim(upload(img, device).float(), -1, 0)
        return torch.movedim(resize_float(x, w, h), 0, -1)
    return upload(cv2.resize(img, (w, h)), device).float()


def _nms(boxes: np.ndarray, scores: np.ndarray, thr: float) -> List[int]:
    """Greedy IoU NMS (cv::dnn::NMSBoxes equivalent).  boxes: (N, 4) xywh."""
    x1, y1 = boxes[:, 0], boxes[:, 1]
    x2, y2 = boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]
    areas = np.maximum(boxes[:, 2], 0) * np.maximum(boxes[:, 3], 0)
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0))
        union = areas[i] + areas[order[1:]] - inter
        iou = np.where(union > 0, inter / union, 0)
        order = order[1:][iou <= thr]
    return keep
