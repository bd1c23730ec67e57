#!/usr/bin/env python
"""raynet_forward_torch: predict per-view depth maps for a scene.

The PyTorch twin of ``raynet_tpu/scripts/forward_pass.py``: the same
positional arguments, flags and ``depth_%03d.npy`` outputs, plus
``--device`` (default ``cuda``), for all four factories, and the port's
own ``mvsnet`` and ``casmvsnet``. As in the JAX package the model is a
``FeatureExtractor`` of ``--cnn_factory`` for every factory of the JAX
package, ``hartmann_fp`` included (which then scores a quintuple by
channel 0 of its features); ``mvsnet`` takes an ``MVSNetModel`` whose
``--weight_file`` is a ``torch.save``d ``MVSNet`` state dict, and writes
(H / 4, W / 4) maps of camera z of the image cropped to multiples of 32;
``casmvsnet`` takes a ``CasMVSNetModel`` whose ``--weight_file`` is a
``torch.save``d ``CasMVSNet`` state dict (cascade-stereo's names), and
writes (H, W) maps of the same crop (its hypotheses are the model's own:
``--depth_planes`` is not read). Scenes are read by the
port's own data layer (``raynet_tpu_torch/common``), so the CLI runs
without the JAX package.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
-m raynet_tpu_torch.scripts.forward_pass ...``) the CLI sets up the ray
group from torchrun's variables (``parallel.sharding``) and the raynet
pass splits each image's rays over the ranks, as the JAX CLI shards over
every visible device, with no flag; rank 0 alone writes the maps and
prints. The other factories run whole on every rank.
"""
import argparse
import os

import numpy as np
import torch

from ..common.generation_parameters import GenerationParameters
from ..common.sampling_schemes import make_sampling_scheme
from ..inference import get_forward_pass_factory
from ..models.feature_extractor import FeatureExtractor
from ..models.casmvsnet import CasMVSNetModel
from ..models.mvsnet import MVSNetModel
from ..parallel import sharding
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
        "--weight_file",
        help="Path to the trained CNN weights (msgpack or Keras .hdf5)"
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

    opened = sharding.current_ray_group() is None
    group = sharding.ray_group_from_env(args.device)
    try:
        _run(args, group is None or group.rank == 0)
    finally:
        if opened and group is not None:
            group.close()


def _run(args, writes):
    factory = get_forward_pass_factory(args.forward_pass_factory)
    if writes:
        os.makedirs(args.output_directory, exist_ok=True)

    generation_params = GenerationParameters.from_options(args)
    sampling_scheme = make_sampling_scheme(
        args.sampling_policy, generation_params, device=args.device)
    dataset = build_dataset(
        args.dataset_type,
        args.dataset_directory,
        args.illumination_condition,
        args.select_neighbors_based_on,
        device=args.device,
    )
    scene = dataset.get_scene(args.scene_idx)

    channels = generation_params.patch_shape[-1]
    cost_volume_models = {"mvsnet": MVSNetModel, "casmvsnet": CasMVSNetModel}
    if args.forward_pass_factory in cost_volume_models:
        model = _cost_volume_model(
            cost_volume_models[args.forward_pass_factory], args.weight_file,
            args.device, writes)
    elif args.weight_file:
        model = FeatureExtractor.from_weights(
            args.cnn_factory, args.weight_file, channels=channels,
            device=args.device,
        )
    else:
        if writes:
            print("WARNING: no --weight_file given; using random CNN weights")
        model = FeatureExtractor(
            args.cnn_factory, channels=channels, device=args.device
        )

    fp = factory(
        model,
        generation_params,
        sampling_scheme,
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
        if writes:
            out = os.path.join(args.output_directory, "depth_%03d.npy" % (i,))
            np.save(out, depth_map.astype(np.float32))
            print("saved", out)


def _cost_volume_model(cls, weight_file, device, writes):
    """The ``cls`` (``MVSNetModel`` or ``CasMVSNetModel``) of
    ``weight_file``, a ``torch.save``d state dict of its network, or random
    weights without one."""
    if not weight_file:
        if writes:
            print("WARNING: no --weight_file given; using random %s "
                  "weights" % cls.__name__)
        return cls(device=device)
    return cls(state_dict=torch.load(weight_file, map_location="cpu"),
               device=device)


if __name__ == "__main__":
    main()
