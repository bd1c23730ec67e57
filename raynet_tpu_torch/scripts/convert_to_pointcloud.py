#!/usr/bin/env python
"""raynet_to_pcl_torch: turn predicted depth maps into a (filtered) point
cloud.

The PyTorch twin of ``raynet_tpu/scripts/convert_to_pointcloud.py``: the
same positional arguments, flags and ``pointcloud_s_%d.ply`` output, plus
``--device`` (default ``cuda``), where the ground-truth raycast and the
backprojection run.
"""
import argparse
import os

import numpy as np

from ..metrics import FiltersFactory, ReduceDensity, VoxelMask
from ..pointcloud import get_pointcloud
from .arguments import (
    add_dataset_related_arguments,
    add_device_arguments,
    add_metrics_related_arguments,
    build_dataset,
)
from .slicing import frame_idxs_type


def find_format(input_directory, key, idx):
    pattern = "_".join([key, "%d.npy" % (idx,)])
    if os.path.isfile(os.path.join(input_directory, pattern)):
        return "_".join([key, "%d.npy"])
    return "_".join([key, "%03d.npy"])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert predicted depth maps into a point cloud"
    )
    parser.add_argument("dataset_directory", help="The dataset to load")
    parser.add_argument(
        "predictions_directory",
        help="The directory containing the model's predictions",
    )
    parser.add_argument(
        "output_directory", help="The directory to save the point cloud"
    )
    parser.add_argument("--scene_idx", type=int, default=0)
    parser.add_argument("--frame_idxs", type=frame_idxs_type, default=":")
    parser.add_argument("--pred_suffix", default="depth")

    add_dataset_related_arguments(parser)
    add_metrics_related_arguments(parser)
    add_device_arguments(parser)
    args = parser.parse_args(argv)

    dataset = build_dataset(
        args.dataset_type,
        args.dataset_directory,
        args.illumination_condition,
        device=args.device,
    )
    scene = dataset.get_scene(args.scene_idx)
    frame_idxs = np.arange(scene.n_images)[args.frame_idxs]

    fmt = find_format(
        args.predictions_directory, args.pred_suffix, frame_idxs[0]
    )
    depthmaps = [
        os.path.join(args.predictions_directory, fmt % (i,))
        for i in frame_idxs
    ]

    pc = get_pointcloud(
        scene,
        list(frame_idxs),
        depthmaps,
        args.with_consistency_check,
        device=args.device,
        borders=args.borders,
        consistency_threshold=args.consistency_threshold,
        n_neighbors=args.n_neighbors,
    )

    filters = []
    mask = scene.observation_mask
    if mask is not None:
        filters.append(VoxelMask(scene.bbox, mask))
    if args.min_distance > 0:
        filters.append(ReduceDensity(args.min_distance))
    ff = FiltersFactory(filters)
    if ff.has_filters:
        pc.filter(ff)

    os.makedirs(args.output_directory, exist_ok=True)
    out = os.path.join(
        args.output_directory, "pointcloud_s_%d.ply" % (args.scene_idx,)
    )
    pc.save_ply(out)
    print("saved", out)


if __name__ == "__main__":
    main()
