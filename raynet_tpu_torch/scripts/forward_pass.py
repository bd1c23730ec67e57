#!/usr/bin/env python
"""raynet_forward_torch: predict per-view depth maps for a scene.

The PyTorch twin of ``raynet_tpu/scripts/forward_pass.py``: the same
positional arguments, flags and ``depth_%03d.npy`` outputs, plus
``--device`` (default ``cuda``). The factories ``raynet``,
``multi_view_cnn`` and ``multi_view_cnn_voxel_space`` are ported;
``hartmann_fp`` raises. Scenes are read by the port's own data layer
(``raynet_tpu_torch/common``), so the CLI runs without the JAX package.
"""
import argparse
import os

import numpy as np

from ..common.generation_parameters import GenerationParameters
from ..inference import get_forward_pass_factory
from ..models.feature_extractor import FeatureExtractor
from .arguments import (
    add_dataset_related_arguments,
    add_device_arguments,
    add_forward_pass_factory_related_arguments,
    add_generation_arguments,
    add_indexing_related_arguments,
    add_mrf_related_arguments,
    add_nn_arguments,
    build_dataset,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=(
            "Do a forward pass and estimate the per-pixel depth "
            "distribution for the images of a scene"
        )
    )
    parser.add_argument(
        "dataset_directory", help="Directory containing the input data"
    )
    parser.add_argument(
        "output_directory", help="Directory to save the output data"
    )
    parser.add_argument(
        "--weight_file", help="Path to the trained CNN weights (msgpack)"
    )
    parser.add_argument("--scene_idx", default=1, type=int)
    parser.add_argument(
        "--filter_out",
        action="store_true",
        help="Filter out rays with zero ground truth",
    )

    add_generation_arguments(parser)
    add_dataset_related_arguments(parser)
    add_indexing_related_arguments(parser)
    add_nn_arguments(parser)
    add_forward_pass_factory_related_arguments(parser)
    add_mrf_related_arguments(parser)
    add_device_arguments(parser)
    args = parser.parse_args(argv)

    factory = get_forward_pass_factory(args.forward_pass_factory)
    os.makedirs(args.output_directory, exist_ok=True)

    generation_params = GenerationParameters.from_options(args)
    dataset = build_dataset(
        args.dataset_type,
        args.dataset_directory,
        args.illumination_condition,
        args.select_neighbors_based_on,
        device=args.device,
    )
    scene = dataset.get_scene(args.scene_idx)

    channels = generation_params.patch_shape[-1]
    if args.weight_file:
        model = FeatureExtractor.from_weights(
            args.cnn_factory, args.weight_file, channels=channels,
            device=args.device,
        )
    else:
        print("WARNING: no --weight_file given; using random CNN weights")
        model = FeatureExtractor(
            args.cnn_factory, channels=channels, device=args.device
        )

    fp = factory(
        model,
        generation_params,
        None,  # the ported passes sample along bbox segments
        scene.image_shape,
        args.rays_batch,
        filter_out_rays=args.filter_out,
        device=args.device,
    )

    start, end = args.start_end
    skip = args.skip_every + 1
    for i, depth_map in zip(
        range(start, end, skip),
        fp.forward_pass(scene, (start, end, skip)),
    ):
        out = os.path.join(args.output_directory, "depth_%03d.npy" % (i,))
        np.save(out, depth_map.astype(np.float32))
        print("saved", out)


if __name__ == "__main__":
    main()
