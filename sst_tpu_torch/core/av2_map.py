"""Self-contained Argoverse 2 HD-map reader: drivable / ROI / ground rasters.

The port's copy of ``sst_tpu/core/av2_map.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Counterpart of the av2-devkit pieces the reference leans on in
`tools/argo/create_roi_mask.py:5-8` (`ArgoverseStaticMap`, `RasterLayerType`,
`load_mapped_avm_and_egoposes`) and in `mmdet3d/datasets/argo2_dataset.py:509-519`
(`DetectionCfg(eval_only_roi_instances=True)` ROI pruning inside the av2
evaluator). The devkit is not installable here, so this module re-implements
the exact subset those call sites need, from av2's on-disk map format:

per-log ``map/`` directory
  - ``log_map_archive_{log_id}__*.json``  vector map; we consume
    ``drivable_areas`` (id -> {"area_boundary": [{"x","y","z"}, ...]})
  - ``{log_id}_ground_height_surface__*.npy``  float16 ground-height raster
    (NaN where undefined)
  - ``{log_id}___img_Sim2_city.json``  {"R": [4], "t": [2], "s": float} --
    the similarity transform mapping city coords to ground-raster coords

per-log ``city_SE3_egovehicle.feather``
  columns [timestamp_ns, qw, qx, qy, qz, tx_m, ty_m, tz_m]

Semantics matched to the devkit (av2.map.map_api):
  - drivable raster built from vector polygons at 0.1 m resolution with a
    +/-1 m bound pad, vertices quantized with round(), filled with PIL
    ``ImageDraw.polygon`` (the devkit's own rasterizer, so fills are
    pixel-identical);
  - ROI = drivable mask dilated by an L2 distance transform at the 5 m
    isocontour (``ROI_ISOCONTOUR_M`` / resolution = 50 px);
  - raster lookups truncate (``astype(int64)``, not round) and index
    ``array[y, x]``; out-of-bounds points get the fill value;
  - ground test: |z - ground_height(x, y)| <= 0.3 m, NaN -> False.
"""

from __future__ import annotations

import glob
import json
import os
from os import path as osp

import numpy as np

# av2.map.map_api constants
GROUND_HEIGHT_THRESHOLD_M = 0.3
ROI_ISOCONTOUR_M = 5.0
DRIVABLE_AREA_RESOLUTION_M = 0.1


def quat_to_mat(qw, qx, qy, qz):
    """wxyz quaternion -> 3x3 rotation matrix (scipy convention)."""
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])


class SE3:
    """Rigid transform; mirrors av2.geometry.se3.SE3 (R p + t)."""

    def __init__(self, rotation, translation):
        self.rotation = np.asarray(rotation, np.float64)
        self.translation = np.asarray(translation, np.float64)

    def transform_point_cloud(self, points):
        points = np.asarray(points, np.float64)
        return points @ self.rotation.T + self.translation

    def inverse(self):
        return SE3(self.rotation.T, -(self.rotation.T @ self.translation))


class Sim2:
    """Similarity transform p' = s * (R p + t); av2.geometry.sim2.Sim2."""

    def __init__(self, R, t, s):
        self.R = np.asarray(R, np.float64).reshape(2, 2)
        self.t = np.asarray(t, np.float64).reshape(2)
        self.s = float(s)

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            d = json.load(f)
        return cls(np.array(d["R"]), np.array(d["t"]), d["s"])

    def transform_from(self, points_xy):
        points_xy = np.asarray(points_xy, np.float64).reshape(-1, 2)
        return self.s * (points_xy @ self.R.T + self.t)


class RasterLayer:
    """A 2D raster + the Sim2 mapping city coords to raster coords
    (av2 RasterMapLayer.get_raster_values_at_coords semantics: truncate to
    int, index [y, x], fill value outside)."""

    def __init__(self, array, array_Sim2_city):
        self.array = np.asarray(array)
        self.array_Sim2_city = array_Sim2_city

    def values_at(self, points_xy_city, fill_value):
        img = self.array_Sim2_city.transform_from(points_xy_city)
        xi = img[:, 0].astype(np.int64)
        yi = img[:, 1].astype(np.int64)
        h, w = self.array.shape[:2]
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.full(len(xi), fill_value,
                      dtype=np.result_type(self.array.dtype,
                                           type(fill_value)))
        out[ok] = self.array[yi[ok], xi[ok]]
        return out


def _fill_polygons(polygons_img, img_h, img_w):
    """av2.utils.raster.get_mask_from_polygons: PIL polygon fill."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", size=(img_w, img_h), color=0)
    draw = ImageDraw.Draw(mask)
    for poly in polygons_img:
        draw.polygon([(float(x), float(y)) for x, y in poly[:, :2]], fill=1)
    return np.array(mask, dtype=np.uint8)


def build_drivable_layer(drivable_polygons_city,
                         resolution=DRIVABLE_AREA_RESOLUTION_M,
                         pad_m=ROI_ISOCONTOUR_M + 1.0):
    """av2 DrivableAreaMapLayer.from_vector_data semantics: raster over the
    drivable-polygon bounds at 0.1 m resolution with round-quantized
    vertices. The bounds are padded by isocontour+1 m (vs the devkit's
    map-wide extent) so the full 5 m ROI dilation ring is representable —
    inside the common extent, fills are pixel-identical (same PIL
    rasterizer, same quantization)."""
    allv = np.concatenate([np.asarray(p)[:, :2]
                           for p in drivable_polygons_city], axis=0)
    x_min, y_min = np.floor(allv.min(axis=0) - pad_m)
    x_max, y_max = np.ceil(allv.max(axis=0) + pad_m)
    s = 1.0 / resolution
    img_h = int((y_max - y_min + 1) * s)
    img_w = int((x_max - x_min + 1) * s)
    sim2 = Sim2(np.eye(2), np.array([-x_min, -y_min]), s)
    polys_img = [np.round(sim2.transform_from(np.asarray(p)[:, :2]))
                 .astype(np.int64) for p in drivable_polygons_city]
    return RasterLayer(_fill_polygons(polys_img, img_h, img_w), sim2)


def build_roi_layer(drivable_layer, isocontour_m=ROI_ISOCONTOUR_M):
    """av2 RoiMapLayer.from_drivable_area_layer: L2 distance-transform
    dilation of the drivable mask at the 5 m isocontour."""
    from scipy.ndimage import distance_transform_edt

    thresh_px = isocontour_m * drivable_layer.array_Sim2_city.s
    complement = 1 - (drivable_layer.array > 0).astype(np.uint8)
    dist = distance_transform_edt(complement)
    return RasterLayer((dist <= thresh_px).astype(np.uint8),
                       drivable_layer.array_Sim2_city)


class ArgoverseStaticMap:
    """The subset of av2.map.map_api.ArgoverseStaticMap that
    create_roi_mask.py and ROI eval pruning consume."""

    def __init__(self, drivable_layer, roi_layer, ground_layer):
        self.drivable_layer = drivable_layer
        self.roi_layer = roi_layer
        self.ground_layer = ground_layer

    @classmethod
    def from_map_dir(cls, map_dir):
        vec = glob.glob(osp.join(map_dir, "log_map_archive_*.json"))
        if not vec:
            raise FileNotFoundError(f"no log_map_archive_*.json in {map_dir}")
        with open(vec[0]) as f:
            vector_map = json.load(f)
        polys = [np.array([[v["x"], v["y"], v.get("z", 0.0)]
                           for v in da["area_boundary"]])
                 for da in vector_map.get("drivable_areas", {}).values()]
        drivable = build_drivable_layer(polys) if polys else None
        roi = build_roi_layer(drivable) if drivable is not None else None

        ground = None
        npys = glob.glob(osp.join(map_dir, "*_ground_height_surface_*.npy"))
        sims = glob.glob(osp.join(map_dir, "*img_Sim2_city.json"))
        if npys and sims:
            arr = np.load(npys[0]).astype(np.float32)
            ground = RasterLayer(arr, Sim2.from_json(sims[0]))
        return cls(drivable, roi, ground)

    def get_raster_layer_points_boolean(self, points_city, layer="roi"):
        lay = self.roi_layer if layer == "roi" else self.drivable_layer
        if lay is None:
            return np.ones(len(points_city), bool)
        vals = lay.values_at(np.asarray(points_city)[:, :2], 0)
        return vals.astype(bool)

    def get_ground_height_at_xy(self, points_city):
        if self.ground_layer is None:
            return np.full(len(points_city), np.nan, np.float32)
        return self.ground_layer.values_at(
            np.asarray(points_city)[:, :2], np.nan).astype(np.float32)

    def get_ground_points_boolean(self, points_city):
        gh = self.get_ground_height_at_xy(points_city)
        z = np.asarray(points_city)[:, 2]
        with np.errstate(invalid="ignore"):
            return np.abs(z - gh) <= GROUND_HEIGHT_THRESHOLD_M


def read_city_SE3_ego(log_dir):
    """av2.utils.io.read_city_SE3_ego: the per-log ego-pose feather ->
    {timestamp_ns: SE3(city <- egovehicle)}."""
    import pandas as pd

    df = pd.read_feather(osp.join(log_dir, "city_SE3_egovehicle.feather"))
    out = {}
    for row in df.itertuples(index=False):
        out[int(row.timestamp_ns)] = SE3(
            quat_to_mat(row.qw, row.qx, row.qy, row.qz),
            np.array([row.tx_m, row.ty_m, row.tz_m]))
    return out


def load_mapped_avm_and_egoposes(log_ids, dataset_dir):
    """av2.evaluation.detection.utils.load_mapped_avm_and_egoposes: per-log
    static map + ego-pose dicts for a sensor-split directory."""
    log_to_avm, log_to_pose = {}, {}
    for log_id in log_ids:
        log_dir = osp.join(str(dataset_dir), log_id)
        log_to_avm[log_id] = ArgoverseStaticMap.from_map_dir(
            osp.join(log_dir, "map"))
        log_to_pose[log_id] = read_city_SE3_ego(log_dir)
    return log_to_avm, log_to_pose


def box_corners_3d(boxes):
    """[N, 7] (cx cy cz l w h yaw, gravity center) -> [N, 8, 3] corners."""
    boxes = np.asarray(boxes, np.float64)
    n = len(boxes)
    sx = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * 0.5
    sy = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * 0.5
    sz = np.array([1, -1, 1, -1, 1, -1, 1, -1]) * 0.5
    local = np.stack([sx[None] * boxes[:, 3:4], sy[None] * boxes[:, 4:5],
                      sz[None] * boxes[:, 5:6]], axis=-1)  # [N, 8, 3]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1] = c, -s
    rot[:, 1, 0], rot[:, 1, 1] = s, c
    rot[:, 2, 2] = 1.0
    return np.einsum("nij,nkj->nki", rot, local) + boxes[:, None, :3]


def compute_objects_in_roi_mask(boxes_city, avm):
    """av2.evaluation.detection.utils.compute_objects_in_roi_mask: keep a
    cuboid iff ANY of its 8 vertices lands inside the ROI raster.
    boxes_city: [N, 7] city-frame gravity-center boxes."""
    if len(boxes_city) == 0:
        return np.zeros(0, bool)
    corners = box_corners_3d(boxes_city).reshape(-1, 3)
    inside = avm.get_raster_layer_points_boolean(corners, "roi")
    return inside.reshape(-1, 8).any(axis=1)
