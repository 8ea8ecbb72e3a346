"""Pure-Python reader and writer of Waymo Open Dataset ``Frame`` protos
and TFRecord files (the port's copy of ``sst_tpu/data/waymo_proto.py``,
numpy code).

The official converter needs the ``waymo_open_dataset`` package and
TensorFlow; this module decodes the protobuf wire format directly (the
mirror image of ``core/waymo_bin.py``), so tfrecords are read, and written
for tests, with no devkit and no ``crc32c`` package. Field numbers follow
the public dataset.proto / label.proto:

Frame: context=1, timestamp_micros=2, pose=3, images=4, lasers=5,
  laser_labels=6, projected_lidar_labels=7, camera_labels=8
Context: name=1, camera_calibrations=2, laser_calibrations=3, stats=4
CameraCalibration: name=1, intrinsic=2, extrinsic=3, width=4, height=5
LaserCalibration: name=1, beam_inclinations=2, beam_inclination_min=3,
  beam_inclination_max=4, extrinsic=5
Laser: name=1, ri_return1=2, ri_return2=3
RangeImage: range_image_compressed=2, camera_projection_compressed=3,
  range_image_pose_compressed=4 (zlib-compressed MatrixFloat/MatrixInt32)
MatrixFloat/MatrixInt32: data=1 (packed), shape=2 (MatrixShape: dims=1)
Transform: transform=1 (16 doubles, row-major 4x4)
Label: box=1, metadata=2, type=3, id=4, detection_difficulty_level=5,
  tracking_difficulty_level=6, num_lidar_points_in_box=7
Label.Box: center_x..heading = 1..7 (doubles)
Label.Metadata: speed_x=1, speed_y=2
CameraLabels: name=1, labels=2
Stats: time_of_day=2, location=3, weather=4
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ------------------------------------------------------------- wire decoding


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yields (field_no, wire_type, value); value is int for varint,
    bytes for length-delimited, raw 4/8-byte bytes for fixed."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _collect(buf: bytes) -> dict:
    out: dict = {}
    for field, wt, v in iter_fields(buf):
        out.setdefault(field, []).append((wt, v))
    return out


def _scalar_doubles(entries) -> np.ndarray:
    """repeated double: accepts both unpacked (wire 1) and packed (wire 2)."""
    parts = [np.frombuffer(v, "<f8") for wt, v in entries if wt in (1, 2)]
    return (np.concatenate(parts).astype(np.float64) if parts
            else np.zeros(0, np.float64))


def _scalar_floats(entries) -> np.ndarray:
    """repeated float: unpacked (wire 5) or packed (wire 2)."""
    parts = [np.frombuffer(v, "<f4") for wt, v in entries if wt in (2, 5)]
    return (np.concatenate(parts).astype(np.float32) if parts
            else np.zeros(0, np.float32))


def _scalar_ints(entries) -> list[int]:
    vals = []
    for wt, v in entries:
        if wt == 0:
            vals.append(v)
        elif wt == 2:
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                vals.append(x)
    return vals


def _first_double(msg, field, default=0.0):
    if field not in msg:
        return default
    vals = _scalar_doubles(msg[field])
    return float(vals[0]) if len(vals) else default


def _first_int(msg, field, default=0):
    if field not in msg:
        return default
    vals = _scalar_ints(msg[field])
    return int(vals[0]) if vals else default


def _first_bytes(msg, field, default=b""):
    if field not in msg:
        return default
    return msg[field][0][1]


def _transform(entries) -> np.ndarray:
    """Transform message → 4x4 matrix (identity when absent/short)."""
    if not entries:
        return np.eye(4)
    msg = _collect(entries[0][1])
    vals = _scalar_doubles(msg.get(1, []))
    if len(vals) != 16:
        return np.eye(4)
    return vals.reshape(4, 4)


def parse_matrix(buf: bytes, dtype="f4") -> np.ndarray:
    """MatrixFloat / MatrixInt32 → ndarray with proto-declared shape."""
    msg = _collect(buf)
    if dtype == "f4":
        data = _scalar_floats(msg.get(1, []))
    else:
        data = np.asarray(_scalar_ints(msg.get(1, [])), np.int32)
    dims = []
    if 2 in msg:
        shape_msg = _collect(msg[2][0][1])
        dims = _scalar_ints(shape_msg.get(1, []))
    return data.reshape(dims) if dims else data


def _parse_range_image(buf: bytes) -> dict:
    msg = _collect(buf)
    out = {}
    if 2 in msg:
        out["range_image"] = parse_matrix(zlib.decompress(msg[2][0][1]))
    if 4 in msg:
        out["pose"] = parse_matrix(zlib.decompress(msg[4][0][1]))
    return out


def _parse_label(buf: bytes) -> dict:
    msg = _collect(buf)
    out = dict(type=_first_int(msg, 3),
               id=_first_bytes(msg, 4).decode("utf-8", "replace"),
               detection_difficulty_level=_first_int(msg, 5),
               tracking_difficulty_level=_first_int(msg, 6),
               num_lidar_points_in_box=_first_int(msg, 7))
    box = _collect(_first_bytes(msg, 1))
    out["box"] = np.asarray(
        [_first_double(box, i) for i in range(1, 8)])  # cx..heading
    meta = _collect(_first_bytes(msg, 2)) if 2 in msg else {}
    out["speed"] = np.asarray(
        [_first_double(meta, 1), _first_double(meta, 2)])
    return out


def parse_frame(buf: bytes) -> dict:
    """Serialized Frame → dict: context_name, timestamp_micros, pose [4,4],
    location, camera_calibrations [{name, intrinsic, extrinsic}],
    laser_calibrations {laser_name: {extrinsic, beam_inclinations,
    beam_inclination_min/max}}, lasers {laser_name: [ri1, ri2] each
    {'range_image': [H,W,C], 'pose': [H,W,6] (TOP only)}},
    laser_labels [...], projected_labels {label_id+cam_suffix: bbox}."""
    msg = _collect(buf)
    ctx = _collect(_first_bytes(msg, 1))
    out = dict(
        context_name=_first_bytes(ctx, 1).decode("utf-8", "replace"),
        timestamp_micros=_first_int(msg, 2),
        pose=_transform(msg.get(3, [])),
    )
    stats = _collect(_first_bytes(ctx, 4)) if 4 in ctx else {}
    out["location"] = _first_bytes(stats, 3).decode("utf-8", "replace")

    cams = []
    for _, v in ctx.get(2, []):
        c = _collect(v)
        cams.append(dict(
            name=_first_int(c, 1),
            intrinsic=_scalar_doubles(c.get(2, [])),
            extrinsic=_transform(c.get(3, [])),
        ))
    out["camera_calibrations"] = cams

    lcal = {}
    for _, v in ctx.get(3, []):
        c = _collect(v)
        lcal[_first_int(c, 1)] = dict(
            beam_inclinations=_scalar_doubles(c.get(2, [])),
            beam_inclination_min=_first_double(c, 3),
            beam_inclination_max=_first_double(c, 4),
            extrinsic=_transform(c.get(5, [])),
        )
    out["laser_calibrations"] = lcal

    lasers = {}
    for _, v in msg.get(5, []):
        laser = _collect(v)
        name = _first_int(laser, 1)
        lasers[name] = [
            _parse_range_image(_first_bytes(laser, 2)) if 2 in laser else {},
            _parse_range_image(_first_bytes(laser, 3)) if 3 in laser else {},
        ]
    out["lasers"] = lasers

    out["laser_labels"] = [_parse_label(v) for _, v in msg.get(6, [])]

    projected = {}
    for _, v in msg.get(7, []):
        cl = _collect(v)
        cam_name = _first_int(cl, 1)
        for _, lv in cl.get(2, []):
            lab = _parse_label(lv)
            b = lab["box"]
            projected[lab["id"]] = dict(
                cam=cam_name,
                bbox=(b[0] - b[3] / 2, b[1] - b[4] / 2,
                      b[0] + b[3] / 2, b[1] + b[4] / 2))
    out["projected_labels"] = projected
    return out


# ---------------------------------------------------- tfrecord file framing


def read_tfrecord(path: str):
    """Yields raw record payloads. TFRecord framing: u64 length, u32 masked
    crc(length), payload, u32 masked crc(payload); CRCs are not verified."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (length,) = struct.unpack("<Q", hdr[:8])
            payload = f.read(length)
            if len(payload) < length:
                return
            f.read(4)  # data crc
            yield payload


# ----------------------------------------------- encoding (test synthesis)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def enc_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def enc_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def enc_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def enc_packed_doubles(field: int, vals) -> bytes:
    return enc_bytes(field, np.asarray(vals, "<f8").tobytes())


def enc_packed_floats(field: int, vals) -> bytes:
    return enc_bytes(field, np.asarray(vals, "<f4").tobytes())


def enc_transform(field: int, mat) -> bytes:
    return enc_bytes(field, enc_packed_doubles(1, np.asarray(mat).reshape(16)))


def enc_matrix_float(arr) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape = b"".join(enc_varint(1, d) for d in arr.shape)
    return enc_packed_floats(1, arr.reshape(-1)) + enc_bytes(2, shape)


def enc_range_image(range_image, pose=None) -> bytes:
    out = enc_bytes(2, zlib.compress(enc_matrix_float(range_image)))
    if pose is not None:
        out += enc_bytes(4, zlib.compress(enc_matrix_float(pose)))
    return out


def enc_label(box7, type_id: int, obj_id: str, num_points: int,
              difficulty: int = 0, speed=(0.0, 0.0)) -> bytes:
    box = b"".join(enc_double(i + 1, float(v)) for i, v in enumerate(box7))
    meta = enc_double(1, speed[0]) + enc_double(2, speed[1])
    return (enc_bytes(1, box) + enc_bytes(2, meta) + enc_varint(3, type_id)
            + enc_bytes(4, obj_id.encode()) + enc_varint(5, difficulty)
            + enc_varint(7, num_points))


def enc_laser_calibration(name: int, extrinsic, beam_inclinations=None,
                          incl_min: float = 0.0,
                          incl_max: float = 0.0) -> bytes:
    out = enc_varint(1, name)
    if beam_inclinations is not None:
        out += enc_packed_doubles(2, beam_inclinations)
    out += enc_double(3, incl_min) + enc_double(4, incl_max)
    out += enc_transform(5, extrinsic)
    return out


def enc_frame(context_name: str, timestamp_micros: int, pose,
              laser_calibrations: bytes, lasers: list[bytes],
              labels: list[bytes]) -> bytes:
    ctx = enc_bytes(1, context_name.encode()) + laser_calibrations
    out = enc_bytes(1, ctx) + enc_varint(2, timestamp_micros)
    out += enc_transform(3, pose)
    for laser in lasers:
        out += enc_bytes(5, laser)
    for lab in labels:
        out += enc_bytes(6, lab)
    return out


_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = None
_CRC32C_LANES = 4096


def _crc_table() -> np.ndarray:
    """The byte table of the reflected CRC-32C (Castagnoli) polynomial."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        t = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            t = np.where(t & 1, (t >> 1) ^ np.uint32(_CRC32C_POLY), t >> 1)
        _CRC32C_TABLE = t.astype(np.uint32)
    return _CRC32C_TABLE


def _crc_bytes(crc: int, data, table) -> int:
    for byte in data:
        crc = int(table[(crc ^ int(byte)) & 0xFF]) ^ (crc >> 8)
    return crc


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``. From 64 bytes a lane up, the data is cut into
    ``_CRC32C_LANES`` equal chunks whose registers advance together, one
    numpy step per byte column, and are then chained: the register update
    is linear, so a chunk's register from 0 is XORed onto the running one
    after that has been carried over the chunk's length in zeros."""
    table = _crc_table()
    lanes = _CRC32C_LANES
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    if n < 64 * lanes:
        return _crc_bytes(0xFFFFFFFF, buf, table) ^ 0xFFFFFFFF
    length = n // lanes
    cols = np.ascontiguousarray(buf[:lanes * length].reshape(lanes, length).T)
    regs = np.zeros(lanes, np.uint32)
    regs[0] = 0xFFFFFFFF
    for col in cols:
        regs = table[(regs ^ col) & 0xFF] ^ (regs >> 8)
    # the carry over `length` zero bytes, per byte of a register
    zeros = (np.arange(256, dtype=np.uint32)[None, :]
             << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
    for _ in range(length):
        zeros = table[zeros & 0xFF] ^ (zeros >> 8)
    z0, z1, z2, z3 = (zeros.reshape(4, 256)).tolist()
    crc = int(regs[0])
    for r in regs[1:].tolist():
        crc = (z0[crc & 0xFF] ^ z1[(crc >> 8) & 0xFF] ^ z2[(crc >> 16) & 0xFF]
               ^ z3[crc >> 24] ^ r)
    return _crc_bytes(crc, buf[lanes * length:], table) ^ 0xFFFFFFFF


def write_tfrecord(path: str, records: list[bytes]):
    """TFRecord writer with valid masked crc32c framing."""
    import struct as _s

    def masked(data: bytes) -> int:
        c = crc32c(data)
        return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF

    with open(path, "wb") as f:
        for rec in records:
            hdr = _s.pack("<Q", len(rec))
            f.write(hdr)
            f.write(_s.pack("<I", masked(hdr)))
            f.write(rec)
            f.write(_s.pack("<I", masked(rec)))
