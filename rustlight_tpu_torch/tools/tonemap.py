"""Image metric / tonemap / falsecolor tool (reference scripts/tonemap.py);
the port's counterpart of tools/tonemap.py, with the same flags and files.

  python -m rustlight_tpu_torch.tools.tonemap img.exr       # -> img.png
  python -m rustlight_tpu_torch.tools.tonemap out.exr -r ref.exr -m mape
  python -m rustlight_tpu_torch.tools.tonemap out.exr -r ref.exr -m l1 \\
      -fc err.png -c 0 0.5

Host-side numpy work on image files: no device is involved, and PNGs are
written without PIL (utils/image.py:encode_png).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..utils import image as rimage
from ..utils.metrics import compute_metric, falsecolor, metric_scalar


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("-e", "--exposure", type=float, default=0.0)
    ap.add_argument("-m", "--metric",
                    choices=["l1", "l2", "mrse", "mape", "smape", "rmse",
                             "dssim"])
    ap.add_argument("-eps", "--epsilon", type=float, default=1e-2)
    ap.add_argument("-c", "--clip", nargs=2, type=float, default=[0, 1])
    ap.add_argument("-fc", "--falsecolor", type=str)
    ap.add_argument("-r", "--ref", type=str)
    ap.add_argument("-p", "--plain", action="store_true",
                    help="print only the metric value")
    args = ap.parse_args(argv)

    ref = rimage.load(args.ref) if args.ref else None
    for inp in args.inputs:
        img = rimage.load(inp) * (2.0 ** args.exposure)
        if args.metric and ref is not None:
            v = metric_scalar(ref, img, args.metric, args.epsilon)
            print(v if args.plain else f"{inp}: {args.metric} = {v:.6g}")
            if args.falsecolor and args.metric in ("l1", "l2", "mrse", "mape",
                                                   "smape"):
                err = compute_metric(ref, img, args.metric, args.epsilon)
                rimage.write_ldr(args.falsecolor, falsecolor(err, args.clip),
                                 gamma=1.0)
        else:
            out = str(Path(inp).with_suffix(".png"))
            rimage.write_ldr(out, img)
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
