"""Ingest the reference AMP mocap clips through OUR poselib pipeline.

The reference ships `assets/amp/motions/*.npy` — SFU-mocap-derived
SkeletonMotion clips for the amp_humanoid (BSD-3-licensed DATA from
NVIDIA IsaacGymEnvs; see its `docs/rl_examples.md` AMP section).  This
script exercises the full in-repo motion pipeline on that real data:

    reference .npy --poselib.SkeletonMotion.from_file--> motion
        --retarget_to_by_tpose (identity mapping onto the same skeleton,
          the same code path FBX/mocap imports go through)-->
        --SkeletonMotion.to_file--> isaacgymenvs_ma_tpu/data/motions/

and verifies the result round-trips through the training-side MotionLib
bit-for-bit (root/dof/key-body trajectories within float tolerance).

Usage:  python scripts/ingest_reference_motions.py [--src DIR] [--dst DIR]
"""
import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")  # MotionLib check; never the GPU

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from isaacgymenvs_ma_tpu.poselib.skeleton import (SkeletonMotion,  # noqa: E402
                                                  SkeletonState)

DEFAULT_SRC = "/root/reference/assets/amp/motions"
DEFAULT_DST = os.path.join(REPO, "isaacgymenvs_ma_tpu", "data", "motions")


def ingest(src_path: str, dst_path: str) -> None:
    motion = SkeletonMotion.from_file(src_path)
    tree = motion.skeleton_tree
    # identity retarget through the T-pose machinery — the same path real
    # mocap retargets take (source skeleton == target skeleton here, so the
    # output must reproduce the input; any pipeline bug shows up as drift)
    tpose = SkeletonState.zero_pose(tree)
    mapping = {n: n for n in tree.node_names}
    out = motion.retarget_to_by_tpose(
        mapping, source_tpose=tpose, target_tpose=tpose,
        scale_to_target_skeleton=1.0)
    drift = float(np.abs(out.global_translation
                         - motion.global_translation).max())
    assert drift < 1e-4, f"identity retarget drifted {drift}"
    out.to_file(dst_path)

    # training-side verification: MotionLib must produce identical banks
    from isaacgymenvs_ma_tpu.learning.motion_lib import MotionLib
    a = MotionLib(src_path, dt=1.0 / 30.0)
    b = MotionLib(dst_path, dt=1.0 / 30.0)
    for field in ("root_pos", "dof_pos", "key_pos"):
        va, vb = getattr(a.data, field), getattr(b.data, field)
        err = float(np.abs(np.asarray(va) - np.asarray(vb)).max())
        assert err < 1e-3, f"{field} mismatch {err}"
    print(f"  {os.path.basename(src_path)} -> {dst_path} "
          f"({out.num_frames} frames @ {out.fps} fps, retarget drift "
          f"{drift:.2e})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=DEFAULT_SRC)
    ap.add_argument("--dst", default=DEFAULT_DST)
    args = ap.parse_args()
    os.makedirs(args.dst, exist_ok=True)
    clips = sorted(f for f in os.listdir(args.src) if f.endswith(".npy"))
    if not clips:
        sys.exit(f"no .npy clips in {args.src}")
    for f in clips:
        ingest(os.path.join(args.src, f), os.path.join(args.dst, f))
    print(f"ingested {len(clips)} clips into {args.dst}")


if __name__ == "__main__":
    main()
