"""FSDv2-Waymo, dense-BEV build, bfloat16 products: the port's build, the
plain reference beside it, the count of operations, the spans, and the
check of a batched predict against the reference.

The reference is ``portbench/ref`` (a frozen copy of the port's model code
in plain PyTorch, every product float32, TF32 off, the kernels' plain
twins) built from the sizes in ``fsdv2_dense_bf16.json``. It reads the same
raw frames and the same weights, and works out the range filter, the
voxels, the fg selection, the virtual voxels and the boxes itself."""

from __future__ import annotations

import math

import numpy as np

from portbench import harness

CLASSES = 3


def build(cfg: dict, traffic: dict, device):
    """The port's build: ``flagship.fsdv2_waymo_dense`` at bfloat16 with
    every batch-global cap times the traffic's batch."""
    import torch

    from sst_tpu_torch.flagship import fsdv2_waymo_dense

    return fsdv2_waymo_dense(max_points=cfg["max_points"],
                             dtype=getattr(torch, cfg["dtype"]),
                             cap_scale=traffic["batch"],
                             num_point_features=cfg["num_point_features"],
                             device=device)


def build_reference(cfg: dict, traffic: dict, device):
    """The plain reference from the file's sizes, float32."""
    import torch

    from portbench.ref.models.fsd.fsdv2 import FSDV2Caps, SingleStageFSDV2

    k = traffic["batch"]
    m = harness.tuples(cfg["model"])
    caps = m.pop("caps")
    m["segmentor"] = dict(m["segmentor"],
                          max_voxels=m["segmentor"]["max_voxels"] * k)
    model = SingleStageFSDV2(
        num_point_features=cfg["num_point_features"],
        caps=FSDV2Caps(fg_per_class=tuple(c * k for c in caps["fg_per_class"]),
                       voxels=caps["voxels"] * k,
                       union_voxels=caps["union_voxels"] * k,
                       virtual_out=caps["virtual_out"] * k),
        dtype=torch.float32, **m)
    return model.to(device).eval()


def init_rule(name: str, shape: tuple):
    """The initializer of a parameter, by name and shape."""
    if name.endswith("z_embed"):
        return ("normal", 0.02)
    if name.endswith("conv_seg.bias"):
        return ("const", -2.0)
    if ".rot.Dense_" in name and len(shape) == 2 and shape[0] == 2:
        # the yaw branch's last layer at a tenth of the usual scale: with
        # ``adjust_weights``' bias the boxes of neighbouring voxels share a
        # heading within a few degrees, as a trained detector's boxes of
        # one object do, and overlap as those do
        return ("normal", 0.1 / math.sqrt(shape[1]))
    if len(shape) >= 2:
        return ("normal", 1.0 / math.sqrt(math.prod(shape[1:])))
    if name.endswith(".bias"):
        return ("const", 0.0)
    if name.endswith(".weight"):
        return ("const", 1.0)
    raise ValueError(f"no initializer for {name} {shape}")


def install_spans(spans, model, traffic) -> None:
    """The stages of predict: the segmentor (a module), the virtual-voxel
    features (sampling, virtual VFE, fusion, mixer: ``extract_feat``),
    decode + NMS (the head's ``get_bboxes``), and every 2D convolution of
    the two dense UNets (ranges named ``conv``)."""
    from torch import nn

    spans.module("segmentor", model.segmentor_mod)
    spans.method("extract_feat", model, "extract_feat")
    spans.method("get_bboxes", model.head_mod, "get_bboxes")
    for unet in (model.segmentor_mod.unet_mod, model.mixer_mod.unet):
        for m in unet.modules():
            if isinstance(m, nn.Conv2d):
                spans.module("conv", m)


FG_FILL = 0.6  # the share of each fg cap the calibrated class biases select
# each task's median box (width, length, height in metres): the Waymo anchor
# sizes of mmdetection3d's Waymo configurations (Car, Pedestrian, Cyclist)
BOX_WLH = ((2.08, 4.73, 1.77), (0.84, 0.91, 1.74), (0.84, 1.81, 1.77))


def adjust_weights(cfg: dict, traffic: dict, pool: list, weights: dict,
                   device) -> dict:
    """Three bias shifts that give every seed the same work, worked out on
    pool frame 0 by the reference's float32 model at batch 1 (a bias
    shift moves each row's logit by the same amount):

    * the seg head's class biases, so that the top ``FG_FILL`` of each
      class's per-frame fg cap scores above its threshold. With random
      weights the share of points over the thresholds swings from none to
      the whole cap with the seed, and with it the virtual voxels;
    * each task's score bias, so that the median score of the valid
      virtual voxels is 0.5. With random weights a class's scores sit
      anywhere from all under ``score_thr`` to all over it, and with them
      the boxes that reach the NMS;
    * each task's size and yaw biases, so that the median box of the valid
      virtual voxels has the class's size ``BOX_WLH`` and heading 0 (its
      sine 0, its cosine 1). With random weights the boxes are a few
      decimetres to metres wide with the seed and point every way, and the
      neighbouring voxels' boxes overlap (and the NMS suppresses) from
      hardly ever to nearly always; an object's size and one heading make
      them overlap as a trained detector's do.

    Returns the deltas by parameter name (``weights`` is changed in
    place)."""
    import torch

    from portbench.ref.models import PointBatch

    ref = build_reference(cfg, dict(traffic, batch=1), device)
    harness.load_weights(ref, weights)
    pcr = cfg["model"]["point_cloud_range"]
    pts, valid = _prepare(pool[0]["points"], pcr, cfg["max_points"])
    batch = PointBatch(points=pts[None], valid=valid[None]).to(device)
    deltas = {}
    with torch.inference_mode():
        seg = ref.segmentor_mod(batch.points[0], torch.zeros(
            len(pts), dtype=torch.int32, device=device), batch.valid[0], 1)
        logits = seg["seg_logits"][seg["valid"]].float()
        caps = cfg["model"]["caps"]["fg_per_class"]
        shifts = []
        for c, thr in enumerate(cfg["model"]["score_thresh"]):
            lc = torch.sort(logits[:, c], descending=True).values
            n = int(FG_FILL * caps[c])
            if lc.numel() <= n:
                raise RuntimeError(f"frame 0 has {lc.numel()} points, too "
                                   f"few to fill {n} of class {c}'s fg cap")
            shifts.append(math.log(thr / (1 - thr))
                          - float(lc[n - 1] + lc[n]) / 2)
        name = next(n for n in weights if n.endswith("conv_seg.bias"))
        deltas[name] = torch.tensor(shifts, device=device)
        del seg
        ref.segmentor_mod.head_mod.conv_seg.bias += deltas[name]
        pipe = ref.run_pipeline(batch, detach_seg=False)
        vv = pipe["ex"]["virtual_valid"]
        if not bool(vv.any()):
            raise RuntimeError("frame 0 gives no virtual voxel")
        for t, lt in enumerate(pipe["outs"]["cls_logits"]):
            # the score branch's last layer: the one with a bias
            name = next(n for n in reversed(list(weights))
                        if n.startswith(f"head_mod.task_{t}.score.Dense_")
                        and n.endswith(".bias"))
            deltas[name] = -lt[vv].float().median(0).values
        for t, reg in enumerate(pipe["outs"]["reg_preds"]):
            name = next(n for n in reversed(list(weights))
                        if n.startswith(f"head_mod.task_{t}.dim.Dense_")
                        and n.endswith(".bias"))
            log_wlh = torch.log(torch.tensor(BOX_WLH[t], device=device))
            deltas[name] = log_wlh - reg[vv][:, 3:6].float().median(0).values
            name = next(n for n in reversed(list(weights))
                        if n.startswith(f"head_mod.task_{t}.rot.Dense_")
                        and n.endswith(".bias"))
            sin_cos = torch.tensor([0.0, 1.0], device=device)
            deltas[name] = sin_cos - reg[vv][:, 6:8].float().median(0).values
    del ref, pipe
    for name, delta in deltas.items():
        weights[name] += delta
    return {n: d.cpu() for n, d in deltas.items()}


# ------------------------------------------------------------- operations

def conv_list(cfg: dict) -> list:
    """Every 2D convolution of one frame's predict, from the widths:
    (cin, cout, kernel, stride, out_h, out_w). The segmentor's UNet runs at
    640x640 (its grid at 0.25 m over 160 m), the mixer's at 320x320 (the
    0.5 m virtual grid), each with stride-2 encoder stages, a nearest
    upsample, a 3x3 up conv, a 1x1 lateral conv and a 3x3 merge conv per
    decoder stage, and a 3x3 output conv."""
    m = cfg["model"]
    pcr = m["point_cloud_range"]
    seg = m["segmentor"]
    ny = round((pcr[4] - pcr[1]) / seg["voxel_size"][1])
    g = seg["z_groups"]
    seg_in = g * (seg["dense_pre_channels"] + 1)
    seg_out = g * seg["dense_group_channels"]
    vy = round((pcr[4] - pcr[1]) / m["virtual_voxel_size"][1])
    vz = round((pcr[5] - pcr[2]) / m["virtual_voxel_size"][2])
    zc = m["mixer"]["z_channels"]
    return (_unet(seg_in, seg["unet"]["encoder_channels"],
                  seg["unet"]["decoder_channels"], seg_out, ny)
            + _unet(vz * zc, m["mixer"]["encoder_channels"],
                    m["mixer"]["decoder_channels"], vz * zc, vy))


def _unet(c_in, enc, dec, c_out, size) -> list:
    convs, c, s, widths = [], c_in, size, []
    for i, stage in enumerate(enc):
        for j, w in enumerate(stage):
            stride = 2 if (i > 0 and j == 0) else 1
            s //= stride
            convs.append((c, w, 3, stride, s, s))
            c = w
        widths.append((c, s))
    n = len(enc)
    for d, w in enumerate(dec):
        skip_c, s = widths[n - 2 - d]
        convs += [(c, w, 3, 1, s, s), (skip_c, w, 1, 1, s, s),
                  (w, w, 3, 1, s, s)]
        c = w
    convs.append((c, c_out, 3, 1, s, s))
    return convs


def conv_flops(convs) -> float:
    """2 k^2 Cin Cout Hout Wout per convolution."""
    return float(sum(2 * k * k * ci * co * h * w
                     for ci, co, k, _, h, w in convs))


def conv_bound_s(convs, peaks: dict, itemsize: int = 2) -> float:
    """The least time of the convolutions on the card: per convolution the
    larger of its operations at the bf16 peak and its bytes (the input
    map, the weight and the output map once each, in bf16) at the memory
    bandwidth."""
    total = 0.0
    for ci, co, k, stride, h, w in convs:
        flops = 2 * k * k * ci * co * h * w
        byts = itemsize * (ci * h * w * stride * stride + k * k * ci * co
                           + co * h * w)
        total += max(flops / peaks["bf16_flops"], byts / peaks["hbm_bytes"])
    return total


def point_mlp_flops(cfg: dict, valid_points: int) -> float:
    """The per-point products of the segmentor: its VFE's two layers and
    its seg head's MLPs and output layers, over the valid points."""
    seg = cfg["model"]["segmentor"]
    c_in = cfg["num_point_features"] + 3 + 3  # decorations: cluster, centre
    f = 0
    for w in seg["vfe"]["feat_channels"]:
        f += 2 * c_in * w
        c_in = 2 * w
    head_in = seg["unet"]["out_channels"] + 3
    c = head_in
    for w in seg["head"]["hidden_dims"]:
        f += 2 * c * w
        c = w
    f += 2 * c * (CLASSES + 3 * CLASSES)
    return float(f) * valid_points


def window_flops(cfg: dict, record: dict) -> float:
    """The model operations of the whole traced window: every frame's
    convolutions and per-point products (virtual-voxel MLPs and the head,
    under 2% of the total by their caps, are not counted)."""
    convs = conv_flops(conv_list(cfg))
    valid = [in_range_points(cfg, f["points"]) for f in record["pool"]]
    return sum(convs + point_mlp_flops(cfg, valid[i])
               for frames in record["window_frames"] for i in frames)


def in_range_points(cfg: dict, points: np.ndarray) -> int:
    pcr = cfg["model"]["point_cloud_range"]
    m = np.ones(len(points), bool)
    for d in range(3):
        m &= (points[:, d] >= pcr[d]) & (points[:, d] < pcr[d + 3])
    return min(int(m.sum()), cfg["max_points"])


# ------------------------------------------------------------ the check

def _prepare(points: np.ndarray, pcr, cap: int):
    """The range filter and the padding to ``cap`` rows."""
    m = np.ones(len(points), bool)
    for d in range(3):
        m &= (points[:, d] >= pcr[d]) & (points[:, d] < pcr[d + 3])
    pts = points[m][:cap]
    out = np.zeros((cap, points.shape[1]), np.float32)
    out[:len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[:len(pts)] = True
    return out, valid


def reference_predict(ref, cfg, frames, device, products=None,
                      nms_faults=None):
    """The reference's final boxes and its candidates (every virtual
    voxel's decoded box and class scores, before NMS) for ``frames``, and
    for each entry of ``nms_faults`` (name: test-config changes) the final
    boxes of a faulty NMS over the same network outputs."""
    import contextlib

    import torch

    from portbench.ref.core.box_coders import base_point_decode
    from portbench.ref.models import PointBatch

    pcr = cfg["model"]["point_cloud_range"]
    pv = [_prepare(f["points"], pcr, cfg["max_points"]) for f in frames]
    batch = PointBatch(points=np.stack([p for p, _ in pv]),
                       valid=np.stack([v for _, v in pv])).to(device)
    faulty = {}
    with torch.inference_mode(), (products or contextlib.nullcontext)():
        pipe = ref.run_pipeline(batch, detach_seg=False)
        ex, outs, head = pipe["ex"], pipe["outs"], ref.head_mod
        args = (outs, ex["virtual_centers"], ex["virtual_batch"],
                ex["virtual_valid"], pipe["batch_size"])
        final = head.get_bboxes(*args, **ref.test_cfg)
        for name, change in (nms_faults or {}).items():
            faulty[name] = _numpy(head.get_bboxes(
                *args, **dict(ref.test_cfg, **change)))
        boxes, scores, batch_of = [], [], []
        for t in range(len(head.tasks)):
            s = torch.sigmoid(outs["cls_logits"][t])
            full = s.new_full((s.shape[0], head.num_classes), -1.0)
            for li, ci in enumerate(head._task_class_ids(t)):
                full[:, ci] = s[:, li]
            boxes.append(base_point_decode(ex["virtual_centers"],
                                           outs["reg_preds"][t],
                                           head.bbox_coder_scale)[:, :7])
            scores.append(torch.where(ex["virtual_valid"][:, None], full,
                                      -1.0))
            batch_of.append(ex["virtual_batch"])
    cand = {"boxes": torch.cat(boxes).double(),
            "scores": torch.cat(scores).double(),
            "batch": torch.cat(batch_of)}
    return _numpy(final), cand, faulty


def _numpy(res: dict) -> dict:
    return {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in res.items()}


def _joint_gap(a, b):
    """[n, m] gap between boxes a [n, 8] and b [m, 8] (x, y, z, l, w, h,
    yaw, score): the largest of the score gap, the centre gaps in metres,
    the log-size gaps and the yaw gap in radians."""
    import torch

    d = (a[:, None, :] - b[None, :, :]).abs()
    la = torch.log(a[:, 3:6].clamp(min=1e-6))
    lb = torch.log(b[:, 3:6].clamp(min=1e-6))
    dsize = (la[:, None, :] - lb[None, :, :]).abs()
    dyaw = torch.remainder(a[:, None, 6] - b[None, :, 6] + math.pi,
                           2 * math.pi) - math.pi
    return torch.stack([d[..., 7], d[..., 0], d[..., 1], d[..., 2],
                        dsize[..., 0], dsize[..., 1], dsize[..., 2],
                        dyaw.abs()], -1).amax(-1)


GAP = 0.1  # a box this near a reference box (joint gap) is the same box
# how far rounding moves an NMS decision: a pair's IoU against the
# threshold, and a box's score against another's or against the cuts
# (``nms_pre``, ``max_num``); set from the program's matched boxes (PERF.md)
MARGIN_IOU = 0.05
MARGIN_SCORE = 0.02
# two boxes the program kept overlap past the threshold by more than the
# IoU's own round-off: the NMS did not suppress
OVERLAP_EPS = 1e-3


def _rows(res, f, c, device):
    import torch

    m = res["valid"][f] & (res["labels"][f] == c)
    return torch.from_numpy(np.concatenate(
        [res["boxes"][f][m][:, :7], res["scores"][f][m][:, None]],
        -1)).double().to(device)


def _nearest(a, b, device):
    """Per row of ``a``, the least joint gap to a row of ``b`` (inf when
    ``b`` is empty), in blocks of rows."""
    import torch

    if b.shape[0] == 0:
        return torch.full((a.shape[0],), math.inf, dtype=torch.float64,
                          device=device)
    return torch.cat([_joint_gap(a[i:i + 64], b).amin(1)
                      for i in range(0, a.shape[0], 64)]) if a.shape[0] \
        else torch.zeros(0, dtype=torch.float64, device=device)


def _iou(a, b, test_cfg, device):
    """[n, m] BEV IoU of boxes a and b as the NMS computes it (rotated,
    or of the nearest axis-aligned boxes), float64."""
    import torch

    from portbench.ref.core.iou import boxes_iou_bev, nearest_iou

    if a.shape[0] == 0 or b.shape[0] == 0:
        return torch.zeros(a.shape[0], b.shape[0], dtype=torch.float64,
                           device=device)
    fn = boxes_iou_bev if test_cfg["use_rotate_nms"] else nearest_iou
    return torch.cat([fn(a[i:i + 256, :7].float(), b[:, :7].float())
                      for i in range(0, a.shape[0], 256)]).double()


def _edge(scores, test_cfg) -> float:
    """The lowest score a class's candidate needs to enter its NMS: above
    ``score_thr`` and among the ``nms_pre`` best."""
    above = scores[scores > test_cfg["score_thr"]]
    if above.numel() <= test_cfg["nms_pre"]:
        return float(test_cfg["score_thr"])
    return float(above.sort(descending=True).values[test_cfg["nms_pre"] - 1])


def compare(result: dict, final: dict, cand: dict, device,
            test_cfg: dict) -> dict:
    """Counts of one batch, frame by frame and class by class, of the
    program's boxes (``program``) against the reference's final boxes
    (``reference``), which hold the program's output to a greedy NMS of
    the reference's candidates, up to rounding:

    * ``not_proposed``: program boxes farther than ``GAP`` from every
      reference candidate of their class and frame (the network does not
      propose them);
    * ``overlapping``: program boxes overlapped past the NMS threshold by a
      program box of their class and frame that ranks before them (the NMS
      let through what it has to suppress);
    * ``uncovered``: reference final boxes that no program box keeps
      (within ``GAP``) or suppresses: a program box suppresses one where it
      overlaps it past the threshold less ``MARGIN_IOU`` and scores at
      least its score less ``MARGIN_SCORE``. A frame may swap boxes at its
      cuts, where rounding reorders the scores: a missing reference box
      within ``MARGIN_SCORE`` of its class's candidate cut (``score_thr``
      or the ``nms_pre``-th score) or, in a frame whose ``max_num`` slots
      the program filled, of the program's lowest kept score, is excused
      as long as the frame holds as many program boxes at those cuts that
      no reference box matches (``swapped`` counts the excused).

    ``wrong`` counts the program boxes that are ``not_proposed`` or
    ``overlapping``, each once."""
    import torch

    thr = test_cfg["nms_thr"]
    out = {"program": 0, "reference": 0, "wrong": 0, "not_proposed": 0,
           "overlapping": 0, "uncovered": 0, "swapped": 0}
    for f in range(result["boxes"].shape[0]):
        full = int(result["valid"][f].sum()) >= test_cfg["max_num"]
        low = (float(result["scores"][f][result["valid"][f]].min())
               if full else -math.inf)
        at_cut, spare = 0, 0
        for c in range(CLASSES):
            p = _rows(result, f, c, device)
            r = _rows(final, f, c, device)
            cm = (cand["batch"] == f) & (cand["scores"][:, c] >= 0)
            cb = torch.cat([cand["boxes"][cm],
                            cand["scores"][cm][:, c:c + 1]], -1)
            out["program"] += p.shape[0]
            out["reference"] += r.shape[0]
            stray = _nearest(p, cb, device) > GAP
            ps, rs = p[:, 7], r[:, 7]
            idx = torch.arange(p.shape[0], device=device)
            ahead = (ps[None, :] > ps[:, None]) | (
                (ps[None, :] == ps[:, None]) & (idx[None, :] < idx[:, None]))
            doubled = ((_iou(p, p, test_cfg, device) > thr + OVERLAP_EPS)
                       & ahead).any(1)
            takes = ((_iou(p, r, test_cfg, device) > thr - MARGIN_IOU)
                     & (ps[:, None] >= rs[None, :] - MARGIN_SCORE)).any(0)
            edge = _edge(cand["scores"][cm][:, c], test_cfg) + MARGIN_SCORE
            missing = ~(_nearest(r, p, device) <= GAP) & ~takes
            r_cut = (rs <= edge) | (rs < low + MARGIN_SCORE)
            p_cut = (ps <= edge) | (ps < low + MARGIN_SCORE)
            out["not_proposed"] += int(stray.sum())
            out["overlapping"] += int(doubled.sum())
            out["wrong"] += int((stray | doubled).sum())
            out["uncovered"] += int((missing & ~r_cut).sum())
            at_cut += int((missing & r_cut).sum())
            spare += int((~(_nearest(p, r, device) <= GAP) & p_cut
                          & ~stray & ~doubled).sum())
        out["uncovered"] += max(0, at_cut - spare)
        out["swapped"] += min(at_cut, spare)
    return out


def numbers(parts: list) -> dict:
    """The compared numbers over the checked batches:

    * ``mismatch_share``: the larger of the share of the program's boxes
      that are wrong (one the reference does not propose, or one the NMS
      should have suppressed) and the share of the reference's boxes that
      the program neither keeps nor suppresses. No box on either side
      reads 1;
    * ``nms_overlap``: the share of the program's boxes overlapped past the
      NMS threshold by a kept box of their class and frame that ranks
      before them. A greedy NMS leaves none, whatever its candidates: the
      comparison is exact."""
    s = {k: sum(p[k] for p in parts) for k in parts[0]}
    if s["program"] + s["reference"] == 0:
        return {"mismatch_share": 1.0, "nms_overlap": 1.0}
    return {"mismatch_share": max(s["wrong"] / max(s["program"], 1)
                                  if s["program"] else 1.0,
                                  s["uncovered"] / max(s["reference"], 1)),
            "nms_overlap": s["overlapping"] / max(s["program"], 1)}


# set from the readings in PERF.md: above the port's largest over its seeds
# (the lower reading) and below the fp8 control's smallest (the upper one),
# nearer the upper in ratio; a greedy NMS leaves no overlap at all
LIMITS = {"mismatch_share": 0.35, "nms_overlap": 0.0}


def check(cfg: dict, traffic: dict, record: dict, seed: int, device):
    """The check of the run: a sample drawn from the seed of the batches
    the window finished, each held against the reference. Returns
    {name: (value, limit)}."""
    n = record["requests"]
    rng = np.random.RandomState(harness_seed(seed))
    k = min(traffic["sample_batches"], n)
    picks = sorted(rng.choice(n, size=k, replace=False).tolist())
    ref = build_reference(cfg, traffic, device)
    weights = harness.draw_weights(ref, seed, init_rule, device)
    harness.apply_adjust(weights, record["weight_adjust"])
    harness.load_weights(ref, weights)
    del weights
    parts = []
    for i in picks:
        frames = [record["pool"][f] for f in record["frames_of"](i)]
        final, cand, _ = reference_predict(ref, cfg, frames, device)
        parts.append(compare(record["results"][i], final, cand, device,
                             ref.test_cfg))
    got = numbers(parts)
    return {k: (v, LIMITS[k]) for k, v in got.items()}


def harness_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 7]).generate_state(1)[0])


# the NMS faults planted in the reference put in the port's place: no
# suppression at all (no IoU passes 1.5), the threshold doubled
NMS_FAULTS = {"no_suppression": {"nms_thr": 1.5},
              "nms_thr_high": {"nms_thr": 0.5}}


def readings(cell, seed: int, device):
    """(side, numbers) for ``seed``: the port's batch 0 of the cell's loop
    against the reference ("program"), the fp8 control in the port's place
    ("control"), the port's answers with two faults planted: half of the
    batch left out ("half_batch"), every box moved 2 m ("answers_shifted"),
    and the reference with each of ``NMS_FAULTS`` in the port's place."""
    import torch

    from portbench import loops
    from portbench.ref.precision import lower_precision

    cfg, traffic = cell.config, cell.traffic
    record = loops.predict(cell, seed, 0.0, False, device)
    ref = build_reference(cfg, traffic, device)
    weights = harness.draw_weights(ref, seed, init_rule, device)
    harness.apply_adjust(weights, record["weight_adjust"])
    harness.load_weights(ref, weights)
    del weights
    frames = [record["pool"][f] for f in record["frames_of"](0)]
    final, cand, faulty = reference_predict(ref, cfg, frames, device,
                                            nms_faults=NMS_FAULTS)
    ctrl, _, _ = reference_predict(ref, cfg, frames, device,
                                   products=lower_precision)
    res = record["results"][0]
    half = dict(res, valid=res["valid"].copy())
    half["valid"][half["valid"].shape[0] // 2:] = False
    shifted = dict(res, boxes=res["boxes"].copy())
    shifted["boxes"][..., 0] += 2.0
    out = []
    for side, got in (("program", res), ("control", ctrl),
                      ("half_batch", half), ("answers_shifted", shifted),
                      *faulty.items()):
        part = compare(got, final, cand, device, ref.test_cfg)
        out.append((side, dict(numbers([part]), **part)))
    del ref
    torch.cuda.empty_cache()
    return out
