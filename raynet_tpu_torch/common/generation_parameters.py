"""GenerationParameters: the typed bag of pipeline hyperparameters shared by
sampling, training and inference.

Copy of ``raynet_tpu/common/generation_parameters.py`` (same defaults: D=32
depth planes, 4 neighbors, 11x11x3 patches, padding = patch height).
"""
import numpy as np

from ..utils.training_utils import dirac_distribution, gaussian_distribution


def get_target_distribution_factory(
    depth_distribution_type, stddev_factor=1.0, std_is_distance=False
):
    if depth_distribution_type == "dirac":
        return dirac_distribution
    if depth_distribution_type == "gaussian":
        return gaussian_distribution(stddev_factor, std_is_distance)
    raise NotImplementedError(
        "unknown target distribution %r" % (depth_distribution_type,)
    )


def get_sampling_type(name):
    if "bbox" in name:
        return "sample_points_in_bbox"
    if "range" in name:
        return "sample_points_in_range"
    if "disparity" in name:
        return "sample_points_in_disparity"
    if "voxel_space" in name:
        return "sample_points_in_voxel_space"
    return None


class GenerationParameters:
    def __init__(
        self,
        depth_planes=32,
        neighbors=4,
        patch_shape=(11, 11, 3),
        grid_shape=np.array([64, 64, 32], dtype=np.int32),
        max_number_of_marched_voxels=400,
        expand_patch=True,
        target_distribution_factory=None,
        depth_range=None,
        step_depth=None,
        padding=None,
        sampling_type=None,
        gamma_mrf=None,
    ):
        self.neighbors = neighbors
        self.patch_shape = patch_shape
        self.expand_patch = expand_patch
        self.depth_planes = depth_planes
        self.grid_shape = grid_shape
        self.depth_range = depth_range
        self.step_depth = step_depth
        self.padding = padding if padding is not None else patch_shape[0]
        self.sampling_type = sampling_type
        self.target_distribution_factory = target_distribution_factory
        self.max_number_of_marched_voxels = max_number_of_marched_voxels
        self.gamma_mrf = gamma_mrf

    @classmethod
    def from_options(cls, argument_parser):
        """Build from an argparse Namespace, tolerating missing groups."""
        args = vars(argument_parser)

        patch_shape = tuple(args.get("patch_shape") or (None,) * 3)
        padding = args.get("padding")
        if padding is None:
            padding = patch_shape[0]

        tdf = None
        if args.get("target_distribution_factory") is not None:
            tdf = get_target_distribution_factory(
                args["target_distribution_factory"],
                args.get("stddev_factor", 1.0),
                args.get("std_is_distance", False),
            )

        sampling_type = None
        if args.get("sampling_policy") is not None:
            sampling_type = get_sampling_type(args["sampling_policy"])

        return cls(
            patch_shape=patch_shape,
            depth_planes=args.get("depth_planes"),
            neighbors=args.get("neighbors"),
            target_distribution_factory=tdf,
            grid_shape=args.get("grid_shape"),
            max_number_of_marched_voxels=args.get(
                "maximum_number_of_marched_voxels"
            ),
            depth_range=args.get("depth_range"),
            step_depth=args.get("step_depth"),
            padding=padding,
            sampling_type=sampling_type,
            gamma_mrf=args.get("initial_gamma_prior"),
        )
