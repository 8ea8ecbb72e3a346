"""Segmentation pretrain → detector init (counterpart of the JAX package's
``tools/model_converters/fsd_pretrain_converter.py``, after the
reference's; docs/overall_instructions.md:52-56): FSD trains its
``VoteSegmentor`` first, then starts the whole detector with that
segmentor.

    python -m sst_tpu_torch.tools.model_converters.fsd_pretrain_converter \\
        --src work_dirs/seg_pretrain/ckpt_N --dst work_dirs/fsd_fresh \\
        [--src-prefix rpn.segmentor_mod] [--dst-prefix rpn.segmentor_mod]

Checkpoints are ``train/checkpoint.py`` directories; the graft works on
``state_dict`` keys, with ``.`` where orbax's paths have ``/``, and
the prefixes default to the two-stage FSD's segmentor, which the port
keeps under ``rpn``. The pretrain's tensors under ``--src-prefix`` (a
detector's segmentor; where the pretrain has no key under it, a bare
``VoteSegmentor``'s, as JAX's tool falls back) replace the destination's
under ``--dst-prefix``; the result, with the destination's
other tensors, optimizer state and step, is written to ``<dst>_init``, from
which ``tools.train --resume-from`` starts.
"""

from __future__ import annotations

import argparse
import os


def graft(src_state: dict, dst_state: dict, src_prefix: str,
          dst_prefix: str) -> dict:
    """``dst_state`` with every tensor of ``src_state`` under
    ``src_prefix`` copied over its counterpart under ``dst_prefix``. Each
    one must exist in the destination with its shape. Unlike JAX's, which
    replaces the whole subtree, the destination's tensors that the source
    lacks stay, so the result still loads strictly."""
    sp = f"{src_prefix}." if src_prefix else ""
    dp = f"{dst_prefix}." if dst_prefix else ""
    out = dict(dst_state)
    n = 0
    for k, v in src_state.items():
        if not k.startswith(sp):
            continue
        dk = dp + k[len(sp):]
        if dk not in dst_state:
            raise KeyError(f"pretrain tensor {k} missing in destination "
                           f"as {dk}")
        if tuple(dst_state[dk].shape) != tuple(v.shape):
            raise ValueError(f"pretrain tensor {k} {tuple(v.shape)} does "
                             f"not fit {dk} {tuple(dst_state[dk].shape)}")
        out[dk] = v
        n += 1
    if not n:
        raise KeyError(f"no pretrain tensor under {src_prefix!r}")
    return out


def main(argv=None) -> str:
    from sst_tpu_torch.train.checkpoint import read_checkpoint, \
        write_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--src-prefix", default="rpn.segmentor_mod")
    ap.add_argument("--dst-prefix", default="rpn.segmentor_mod")
    args = ap.parse_args(argv)

    src = read_checkpoint(args.src)["model"]
    dst = read_checkpoint(args.dst)
    # the pretrain may be a bare VoteSegmentor (no prefix) or a detector
    sp = args.src_prefix if any(
        k.startswith(args.src_prefix + ".") for k in src) else ""
    dst["model"] = graft(src, dst["model"], sp, args.dst_prefix)
    out = write_checkpoint(os.path.abspath(args.dst) + "_init", dst)
    print(f"saved grafted checkpoint to {out}")
    return out


if __name__ == "__main__":
    main()
