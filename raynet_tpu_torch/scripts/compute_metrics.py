#!/usr/bin/env python
"""raynet_compute_metrics_torch: evaluate predicted depth maps / point
clouds.

The PyTorch twin of ``raynet_tpu/scripts/compute_metrics.py``: the same
positionals (dataset, predictions dir, metric names), flags,
predicted_pc_s_%d.ply export, colored metric cloud and mean/median
printout, plus ``--device`` (default ``cuda``), where the ground-truth
raycast and the backprojection run. ``--output_directory`` defaults to the
system's temporary directory.
"""
import argparse
import os
import tempfile

import numpy as np

from ..metrics import (
    Accuracy,
    Completeness,
    FiltersFactory,
    PerPixelMeanDepthError,
    ReduceDensity,
    VoxelMask,
)
from ..pointcloud import Pointcloud, get_pointcloud
from .arguments import (
    add_dataset_related_arguments,
    add_device_arguments,
    add_metrics_related_arguments,
    build_dataset,
)
from .slicing import frame_idxs_type


def build_filter_factory(scene, min_distance, output_directory=None):
    filters = []
    mask = scene.observation_mask
    if mask is not None:
        filters.append(VoxelMask(scene.bbox, mask, output_directory))
    if min_distance > 0:
        filters.append(ReduceDensity(min_distance, output_directory))
    return FiltersFactory(filters)


def build_metric(
    metric_name, filter_factory, truncate, borders, use_pc_from_depthmap,
    device="cuda",
):
    return {
        "ppmde": lambda: PerPixelMeanDepthError(borders),
        "accuracy": lambda: Accuracy(
            filter_factory, truncate, borders, use_pc_from_depthmap, device
        ),
        "completeness": lambda: Completeness(
            filter_factory, truncate, borders, use_pc_from_depthmap, device
        ),
    }[metric_name]()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Compute the 3D reconstruction metrics"
    )
    parser.add_argument("dataset_directory", help="The dataset to load")
    parser.add_argument(
        "predictions_directory",
        help="The directory containing the model's predictions",
    )
    parser.add_argument(
        "metric",
        nargs="+",
        choices=["ppmde", "accuracy", "completeness"],
        help="Choose one or more metrics",
    )
    parser.add_argument("--output_directory", default=tempfile.gettempdir())
    parser.add_argument("--scene_idx", type=int, default=0)
    parser.add_argument("--frame_idxs", type=frame_idxs_type, default=":")
    parser.add_argument("--predicted_files_format", default="depth_%03d.npy")
    parser.add_argument("--use_pc_from_depthmap", action="store_true")

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

    depthmaps = [
        os.path.join(
            args.predictions_directory, args.predicted_files_format % (i,)
        )
        for i in frame_idxs
    ]

    predicted_pc = get_pointcloud(
        scene,
        list(frame_idxs),
        depthmaps,
        args.with_consistency_check,
        device=args.device,
        borders=args.borders,
        consistency_threshold=args.consistency_threshold,
        n_neighbors=args.n_neighbors,
    )
    os.makedirs(args.output_directory, exist_ok=True)
    predicted_pc.save_ply(
        os.path.join(
            args.output_directory, "predicted_pc_s_%d.ply" % (args.scene_idx,)
        )
    )

    filter_factory = build_filter_factory(
        scene, args.min_distance, args.output_directory
    )

    for name in args.metric:
        metric = build_metric(
            name,
            filter_factory,
            args.truncate,
            args.borders,
            args.use_pc_from_depthmap,
            args.device,
        )
        values, points = metric.compute(
            scene, list(frame_idxs), depthmaps, predicted_pc
        )
        print(
            "%s: mean=%f median=%f"
            % (name, np.mean(values), np.median(values))
        )
        if points is not None:
            Pointcloud(points).save_colored_ply(
                os.path.join(
                    args.output_directory,
                    "%s_colored_pc_s_%d.ply" % (name, args.scene_idx),
                ),
                np.asarray(values).ravel(),
            )


if __name__ == "__main__":
    main()
