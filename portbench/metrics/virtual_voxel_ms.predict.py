"""virtual_voxel_ms.predict: CUDA-event ms of ``extract_feat`` (fg
sampling, virtual points and voxels, the virtual VFE, the multiscale
fusion and the mixer) per batch, total over the traced window over the
calls."""


def read(ctx):
    s = ctx["record"].get("spans", {}).get("extract_feat")
    return s["total_ms"] / s["count"] if s and s["count"] else None
