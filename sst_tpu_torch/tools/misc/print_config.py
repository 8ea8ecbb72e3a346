"""Print a fully resolved config (counterpart of the JAX package's
``tools/misc/print_config.py``): the python config with its ``_base_``
files merged and ``--cfg-options`` applied, pretty-printed.

    python -m sst_tpu_torch.tools.misc.print_config CONFIG \\
        [--cfg-options key=value ...]
"""

from __future__ import annotations

import argparse
import pprint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Print the whole config")
    p.add_argument("config", help="config file path")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="key=value overrides (dots traverse nesting)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from sst_tpu_torch.tools.train import apply_cfg_options
    from sst_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options or [])
    print("Config:")
    pprint.pprint(cfg, width=100, sort_dicts=False)
    return cfg


if __name__ == "__main__":
    main()
