"""Waymo leaderboard submission packer without the devkit (counterpart of
the JAX package's ``tools/create_submission.py``, in place of the Waymo
toolkit's ``create_submission`` binary).

Reads prediction ``Objects`` bins (``WaymoDataset.format_results``,
``core/waymo_bin.py``) and a small text file of the submission's metadata
(``key: value`` lines; ``authors`` may repeat), and writes ``--num-shards``
serialized ``Submission`` protos, ``<output-filename>0`` to ``N-1``. The
objects are regrouped as raw bytes, never decoded. The Submission wire
schema (waymo_open_dataset/protos/submission.proto):

  message Submission {
    Task task = 1;               // enum: 2 = DETECTION_3D, 4 = TRACKING_3D
    string unique_method_name = 2;
    repeated string authors = 3;
    string affiliation = 4;
    string description = 5;
    string method_link = 6;
    int32 number_past_frames_exclude_current = 9;
    int32 number_future_frames_exclude_current = 10;
    Objects inference_results = 11;
    SensorType sensor_type = 12; // enum: 1 = LIDAR_ALL
    string account_name = 13;
    repeated Label.Type object_types = 14;
    float latency_second = 15;
  }

    python -m sst_tpu_torch.tools.create_submission \\
        --input-filenames work_dirs/pred.bin \\
        --submission-filename tools/sub_example.txt \\
        --output-filename work_dirs/my_model/submission --num-shards 4
"""

from __future__ import annotations

import argparse
import os

from sst_tpu_torch.core.waymo_bin import (
    _bytes,
    _float,
    _parse_fields,
    _tag,
    _varint,
)

TASKS = {"DETECTION_3D": 2, "TRACKING_3D": 4, "DETECTION_2D": 1,
         "TRACKING_2D": 3, "DOMAIN_ADAPTATION": 5}
SENSORS = {"LIDAR_ALL": 1, "LIDAR_TOP": 2, "CAMERA_ALL": 3,
           "CAMERA_LIDAR_TOP": 4, "CAMERA_LIDAR_ALL": 5}


def _string(field: int, s: str) -> bytes:
    return _bytes(field, s.encode("utf-8"))


def read_objects_payload(path: str) -> list[bytes]:
    """An Objects bin split into its repeated ``objects`` payloads (field
    1), not decoded."""
    with open(path, "rb") as f:
        buf = f.read()
    return [v for fn, wt, v in _parse_fields(buf) if fn == 1 and wt == 2]


def load_meta(path: str) -> dict:
    """The ``key: value`` metadata file; repeated ``authors`` lines
    accumulate, ``#`` starts a comment line."""
    meta: dict = {"authors": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            k, _, v = line.partition(":")
            k, v = k.strip(), v.strip().strip('"')
            if k == "authors":
                meta["authors"].append(v)
            else:
                meta[k] = v
    return meta


def encode_submission(meta: dict, object_payloads: list[bytes]) -> bytes:
    out = []
    out.append(_tag(1, 0) + _varint(TASKS[meta.get("task", "DETECTION_3D")]))
    if meta.get("unique_method_name"):
        out.append(_string(2, meta["unique_method_name"]))
    for a in meta.get("authors", []):
        out.append(_string(3, a))
    for field, key in ((4, "affiliation"), (5, "description"),
                       (6, "method_link")):
        if meta.get(key):
            out.append(_string(field, meta[key]))
    out.append(_tag(9, 0) + _varint(int(meta.get("num_past_frames", 0))))
    out.append(_tag(10, 0) + _varint(int(meta.get("num_future_frames", 0))))
    objects = b"".join(_bytes(1, p) for p in object_payloads)
    out.append(_bytes(11, objects))
    out.append(_tag(12, 0)
               + _varint(SENSORS[meta.get("sensor_type", "LIDAR_ALL")]))
    if meta.get("account_name"):
        out.append(_string(13, meta["account_name"]))
    if meta.get("latency_second"):
        out.append(_float(15, float(meta["latency_second"])))
    return b"".join(out)


def main(argv=None) -> list[str]:
    """Run the CLI; returns the shard paths written."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-filenames", nargs="+", required=True,
                   help="prediction Objects bin(s)")
    p.add_argument("--submission-filename", required=True,
                   help="text config: account_name/unique_method_name/"
                        "authors/affiliation/description/... (see "
                        "tools/sub_example.txt)")
    p.add_argument("--output-filename", required=True,
                   help="output prefix; writes <prefix>0 .. <prefix>N-1")
    p.add_argument("--num-shards", type=int, default=4)
    args = p.parse_args(argv)

    meta = load_meta(args.submission_filename)
    payloads: list[bytes] = []
    for path in args.input_filenames:
        payloads.extend(read_objects_payload(path))
    print(f"total objects: {len(payloads)}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output_filename)),
                exist_ok=True)
    paths = []
    for s in range(args.num_shards):
        shard = payloads[s::args.num_shards]
        paths.append(f"{args.output_filename}{s}")
        with open(paths[-1], "wb") as f:
            f.write(encode_submission(meta, shard))
    print(f"total submissions: {args.num_shards}")
    return paths


if __name__ == "__main__":
    main()
