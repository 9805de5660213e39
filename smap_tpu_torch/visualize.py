"""Result viewer: ``python -m smap_tpu_torch.visualize`` (counterpart of
``scripts/visualize.py``; the reference's ``lib/visualize/vis.py``).

Draws each item of a result JSON (``test_smap``'s output) as its image
beside a 3D plot of the predicted skeletons. Needs matplotlib; runs on the
host.

Usage:
  python -m smap_tpu_torch.visualize --result-json r.json \\
      --image-root imgs [--out-dir vis/] [--limit 10]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.visualize",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--result-json", required=True)
    parser.add_argument("--image-root", default="")
    parser.add_argument("--out-dir", default="",
                        help="save vis_<i>.png here (default: show each)")
    parser.add_argument("--limit", type=int, default=0,
                        help="the first N items only")
    args = parser.parse_args(argv)

    from smap_tpu_torch.utils.visualize import visualize_results

    visualize_results(args.result_json, args.image_root,
                      args.out_dir or None, args.limit)


if __name__ == "__main__":
    main()
