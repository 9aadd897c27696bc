"""CLI: Sim(3)-aligned ATE RMSE between two TUM trajectories (port of
``mast3r_slam_tpu/eval/ate.py``), in place of `evo_ape tum <gt> <est> -as`.

    python -m mast3r_slam_tpu_torch.eval.ate est.txt gt.txt [--max-dt 0.02]

Prints {"ate_rmse": ..., "est": ..., "gt": ...} and returns the RMSE (None
with fewer than 3 associated poses).
"""

from __future__ import annotations

import argparse
import json

from .trajectory import ate_rmse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--max-dt", type=float, default=0.02)
    p.add_argument("--no-scale", action="store_true",
                   help="SE(3) alignment instead of Sim(3)")
    args = p.parse_args(argv)
    ate = ate_rmse(args.est, args.gt, max_dt=args.max_dt,
                   with_scale=not args.no_scale)
    print(json.dumps({"ate_rmse": ate, "est": args.est, "gt": args.gt}))
    return ate


if __name__ == "__main__":
    main()
