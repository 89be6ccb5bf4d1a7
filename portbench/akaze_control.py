"""Upper readings of the AKAZE cell that portbench/control.py does not
give. Its control, the reference with TF32, moves no number of that cell
3x (TF32 reaches only the reference's Scharr convolutions there), and the
faults of portbench/faults.py leave the frontend alone. Here the program
runs altered, and its readings are upper readings:

    python3 -m portbench.akaze_control --alter <name> --workload akaze-session-d2 \\
        --seeds 1,2,3 --seconds 5

prints portbench.control's lines (any of its arguments) for the program
with ALTERATIONS[<name>] in place. Lower precision than the
configuration's float32 (TF32 off):

  tf32              TF32 on for the program's float32 products and
                    convolutions (the pose LM's normal equations and the
                    covariance among them) in every
                    ColocSession.intra_pose_chunk call, its capture too
  scale_space_bf16  the scale space (L, Lx, Ly and the detector's
                    response) rounded through bfloat16 where it is built

Faults planted in the AKAZE frontend:

  subpixel_dropped  every keypoint at its integer pixel
  angle_turned      every orientation turned by 0.2 rad: the same
                    keypoints, other bits
  threshold_doubled the detector's response threshold 1e-4 -> 2e-4
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import sys

import torch

from portbench import control
from portbench.reference import pipeline


def _tf32(old):
    def f(*args, **kw):
        with pipeline.precision(True):
            return old(*args, **kw)
    return f


def _bf16_levels(old):
    def f(*args, **kw):
        return [ev._replace(**{k: getattr(ev, k).to(torch.bfloat16).to(torch.float32)
                               for k in ("L", "Lx", "Ly", "response")})
                for ev in old(*args, **kw)]
    return f


def _zero_offsets(old):
    def f(score, x, y):
        zero = torch.zeros(x.shape, device=x.device)
        return zero, zero.clone()
    return f


def _turned(old):
    def f(*args, **kw):
        return old(*args, **kw) + 0.2
    return f


# name -> (module, attribute, possibly dotted, the wrapper of the original)
ALTERATIONS = {
    "tf32": ("coloc_tpu_torch.session", "ColocSession.intra_pose_chunk", _tf32),
    "scale_space_bf16": ("coloc_tpu_torch.ops.diffusion", "build_scale_space_batch",
                         _bf16_levels),
    "subpixel_dropped": ("coloc_tpu_torch.ops.fast", "subpixel_offsets", _zero_offsets),
    "angle_turned": ("coloc_tpu_torch.ops.mldb", "orientation", _turned),
    "threshold_doubled": ("coloc_tpu_torch.akaze", "_RESPONSE_THRESHOLD", lambda old: 2 * old),
}


@contextlib.contextmanager
def altered(name: str):
    """The program with ALTERATIONS[name] in place."""
    module, attr, wrap = ALTERATIONS[name]
    owner = importlib.import_module(module)
    *path, leaf = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    old = getattr(owner, leaf)
    setattr(owner, leaf, wrap(old))
    try:
        yield
    finally:
        setattr(owner, leaf, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alter", required=True, choices=sorted(ALTERATIONS))
    args, rest = ap.parse_known_args(argv)
    print(f"altered: {args.alter}", file=sys.stderr)
    with altered(args.alter):
        return control.main(rest)


if __name__ == "__main__":
    sys.exit(main())
