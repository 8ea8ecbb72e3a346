"""Waymo Open Dataset ``Objects`` serialization without the devkit (the
port's copy of ``sst_tpu/core/waymo_bin.py``, numpy code; the port cannot
import the JAX package, whose ``__init__`` loads JAX).

LiDAR-frame detections (mmdet3d v0.15 bottom-centre boxes and yaw) become
serialized ``metrics_pb2.Objects`` files, the input of the official
``compute_detection_metrics_main`` binary, of the leaderboard packer
(``tools/create_submission.py``), of FSD++'s seed tools and of CTRL. The
protobuf wire format is written directly, and a small decoder reads it
back. The same frames give the same bytes as the JAX package's writer.
Field numbers follow the public protos:

  metrics.proto  Object:  object=1 (Label), score=2 (float),
                 overlap_with_nlz=3, context_name=4 (string),
                 frame_timestamp_micros=5 (int64)
                 Objects: objects=1 (repeated Object)
  label.proto    Label:   box=1 (Box), type=3 (enum), id=4 (string)
                 Label.Box: center_x=1, center_y=2, center_z=3 (double),
                 length=4, width=5, height=6, heading=7 (double)

Where ``waymo_open_dataset`` is importable, the writer uses its protos.
"""

from __future__ import annotations

import math
import struct

import numpy as np

# Label.Type enum values (label.proto)
TYPE_UNKNOWN, TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = 0, 1, 2, 3, 4

K2W_CLS_MAP = {
    "Car": TYPE_VEHICLE,
    "Pedestrian": TYPE_PEDESTRIAN,
    "Sign": TYPE_SIGN,
    "Cyclist": TYPE_CYCLIST,
}


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", float(v))


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def lidar_to_waymo_heading(yaw: float) -> float:
    """mmdet3d v0.15 LiDAR yaw → WOD heading (waymo_dataset.py:760-767)."""
    heading = -yaw - 0.5 * math.pi
    while heading < -math.pi:
        heading += 2 * math.pi
    while heading > math.pi:
        heading -= 2 * math.pi
    return heading


def encode_object(box7, score: float, class_name: str, context_name: str,
                  timestamp_micros: int, obj_id: str | None = None) -> bytes:
    """One metrics_pb2.Object from a LiDAR 7-dof box
    [x, y, z_bottom, w, l, h, yaw]. obj_id populates Label.id (field 4) for
    tracking bins."""
    x, y, z, w, l, h, yaw = (float(v) for v in box7[:7])
    # official label.proto field order: length=4, width=5 (lidar row keeps
    # [w, l]; swapping here, not in the row, keeps mmdet3d v0.15 parity)
    box = (
        _double(1, x) + _double(2, y) + _double(3, z + h / 2)
        + _double(4, l) + _double(5, w) + _double(6, h)
        + _double(7, lidar_to_waymo_heading(yaw))
    )
    label = _bytes(1, box) + _int64(3, K2W_CLS_MAP.get(class_name, TYPE_UNKNOWN))
    if obj_id:
        label += _bytes(4, obj_id.encode())
    obj = (
        _bytes(1, label)
        + _float(2, score)
        + _bytes(4, context_name.encode())
        + _int64(5, timestamp_micros)
    )
    return _bytes(1, obj)  # Objects.objects entry


def write_waymo_bin(path: str, frames, class_names=("Car", "Pedestrian", "Cyclist")):
    """frames: iterable of dicts with keys boxes [N,7+], scores [N],
    labels [N], context_name (str), timestamp_micros (int).

    Prefers the official protos when available; otherwise writes the wire
    format directly."""
    try:
        from waymo_open_dataset import label_pb2  # noqa: F401
        from waymo_open_dataset.protos import metrics_pb2

        objects = metrics_pb2.Objects()
        for fr in frames:
            ids = fr.get("obj_ids")
            for i in range(len(fr["boxes"])):
                b = np.asarray(fr["boxes"][i], np.float64)
                o = objects.objects.add()
                if ids is not None and ids[i]:
                    o.object.id = str(ids[i])
                o.object.box.center_x = b[0]
                o.object.box.center_y = b[1]
                o.object.box.center_z = b[2] + b[5] / 2
                o.object.box.width = b[3]
                o.object.box.length = b[4]
                o.object.box.height = b[5]
                o.object.box.heading = lidar_to_waymo_heading(b[6])
                o.object.type = K2W_CLS_MAP.get(
                    class_names[int(fr["labels"][i])], TYPE_UNKNOWN)
                o.score = float(fr["scores"][i])
                o.context_name = fr["context_name"]
                o.frame_timestamp_micros = int(fr["timestamp_micros"])
        with open(path, "wb") as f:
            f.write(objects.SerializeToString())
        return path
    except ImportError:
        pass
    with open(path, "wb") as f:
        for fr in frames:
            boxes = np.asarray(fr["boxes"], np.float64)
            ids = fr.get("obj_ids")
            for i in range(len(boxes)):
                f.write(
                    encode_object(
                        boxes[i], float(fr["scores"][i]),
                        class_names[int(fr["labels"][i])],
                        fr["context_name"], int(fr["timestamp_micros"]),
                        obj_id=ids[i] if ids is not None else None,
                    )
                )
    return path


# ----------------------------------------------------------- minimal decoder


def _read_varint(buf, pos):
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _parse_fields(buf):
    pos = 0
    out = []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"wire type {wire}")
        out.append((field, wire, v))
    return out


def read_waymo_bin(path: str):
    """Decode an Objects bin into a list of dicts (round-trip testing +
    FSD++ seed-box generation from saved bins)."""
    with open(path, "rb") as f:
        buf = f.read()
    results = []
    for field, wire, payload in _parse_fields(buf):
        if field != 1 or wire != 2:
            continue
        obj = {"score": 0.0, "context_name": "", "timestamp_micros": 0}
        for f2, w2, v2 in _parse_fields(payload):
            if f2 == 1 and w2 == 2:  # Label
                for f3, w3, v3 in _parse_fields(v2):
                    if f3 == 1 and w3 == 2:  # Box
                        box = dict(_parse_box(v3))
                        obj["box"] = box
                    elif f3 == 3:
                        obj["type"] = v3
                    elif f3 == 4 and w3 == 2:  # Label.id
                        obj["id"] = v3.decode()
            elif f2 == 2:
                obj["score"] = v2
            elif f2 == 4:
                obj["context_name"] = v2.decode()
            elif f2 == 5:
                obj["timestamp_micros"] = v2
        results.append(obj)
    return results


def _parse_box(buf):
    names = {1: "center_x", 2: "center_y", 3: "center_z", 4: "length",
             5: "width", 6: "height", 7: "heading"}
    for f, w, v in _parse_fields(buf):
        if f in names:
            yield names[f], v


def waymo_box_to_lidar(box: dict) -> np.ndarray:
    """Inverse of lidar2waymo_box: WOD box dict → mmdet3d 7-dof row."""
    yaw = -box["heading"] - 0.5 * math.pi
    while yaw < -math.pi:
        yaw += 2 * math.pi
    while yaw > math.pi:
        yaw -= 2 * math.pi
    return np.asarray(
        [box["center_x"], box["center_y"], box["center_z"] - box["height"] / 2,
         box["width"], box["length"], box["height"], yaw], np.float32,
    )


def read_bin_as_frames(path: str):
    """Decode an Objects bin into per-frame prediction/gt dicts keyed by
    (context_name, timestamp): {'boxes' [N,7] lidar, 'scores', 'labels'
    (0 veh / 1 ped / 2 cyc), 'obj_ids'} — the input format of
    core.eval_waymo.waymo_eval."""
    type2label = {1: 0, 2: 1, 4: 2}
    frames: dict = {}
    for o in read_waymo_bin(path):
        # Official gt bins also carry TYPE_SIGN (3) / TYPE_UNKNOWN (0);
        # drop anything outside the three detection classes rather than
        # miscounting it as vehicle.
        label = type2label.get(int(o.get("type", 1)))
        if label is None:
            continue
        key = (o["context_name"], o["timestamp_micros"])
        fr = frames.setdefault(
            key, dict(boxes=[], scores=[], labels=[], obj_ids=[]))
        fr["boxes"].append(waymo_box_to_lidar(o["box"]))
        fr["scores"].append(o.get("score", 0.0))
        fr["labels"].append(label)
        fr["obj_ids"].append(o.get("id", ""))
    out = {}
    for key, fr in frames.items():
        out[key] = dict(
            boxes=np.stack(fr["boxes"]) if fr["boxes"] else np.zeros((0, 7)),
            scores=np.asarray(fr["scores"], np.float32),
            labels=np.asarray(fr["labels"], np.int32),
            obj_ids=fr["obj_ids"],
        )
    return out
