"""The argparse groups the port's CLIs use.

Same flag names, choices and defaults as ``raynet_tpu/scripts/arguments.py``
(which imports the JAX training code, so the groups are repeated here),
plus ``--device``; ``build_dataset`` gives its scenes that device.
"""
import os

from ..common.dataset import DTUDataset, RestrepoDataset
from ..train.sample import (
    CompareWithReferenceSampleGenerator,
    DefaultSampleGenerator,
    HartmannSampleGenerator,
)


def add_nn_arguments(parser):
    parser.add_argument("--lr", type=float, default=1e-3,
                        help="Learning rate (default 1e-3)")
    parser.add_argument("--reducer", choices=["max", "average", "topK"],
                        default="average",
                        help="Pair-axis reducer for similarity scores")
    parser.add_argument("--merge_layer",
                        choices=["dot-product", "cosine-similarity"],
                        default="dot-product",
                        help="Feature merge operation")
    parser.add_argument("--k", type=int, default=5,
                        help="k for the topK reducer")
    parser.add_argument("--optimizer", choices=["Adam", "SGD"],
                        default="Adam")
    parser.add_argument("--momentum", type=float, default=0.9,
                        help="SGD momentum")
    parser.add_argument(
        "--network_architecture",
        choices=[
            "simple_cnn",
            "simple_nn_for_training",
            "simple_nn_for_training_voxel_space",
            "hartmann",
        ],
        default="simple_nn_for_training",
    )
    parser.add_argument(
        "--cnn_factory",
        choices=[
            "simple_cnn",
            "simple_cnn_ln",
            "dilated_cnn_receptive_field_25",
            "dilated_cnn_receptive_field_25_with_tanh",
            "hartmann_cnn",
        ],
        default="simple_cnn",
        help="Feature-extractor architecture for the Multi-View CNN",
    )
    parser.add_argument(
        "--loss",
        choices=[
            "categorical_crossentropy",
            "emd",
            "squared_emd",
            "expected_squared_error",
        ],
        default="emd",
    )
    parser.add_argument("--padding", default=None, type=int,
                        help="Zero padding around images")
    parser.add_argument("--weight_decay", type=float, default=0.0,
                        help="L2 regularizer factor")


def add_training_arguments(parser):
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--steps_per_epoch", type=int, default=500)
    parser.add_argument("--training_cached_samples", type=int, default=500,
                        help="Samples kept in the prefetch cache")
    parser.add_argument("--n_test_samples", type=int, default=500)
    parser.add_argument(
        "--lr_epochs",
        type=lambda x: [int(v) for v in x.split(",")],
        default="50,80,100,120",
        help="Epochs at which the learning rate is reduced",
    )
    parser.add_argument("--lr_factor", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=32)


def add_experiments_related_arguments(parser):
    parser.add_argument("--training_set_name", default="BH")
    parser.add_argument("--test_set_name", default="Downtown")
    parser.add_argument(
        "--credentials",
        default=os.path.join(os.path.dirname(__file__), ".credentials"),
    )
    parser.add_argument("--spreadsheet", default="Sheet1")


def add_hartmann_related_arguments(parser):
    parser.add_argument("--step_depth", default=15, type=int)


def add_generation_arguments(parser):
    parser.add_argument(
        "--patch_shape",
        type=lambda x: tuple(int(v) for v in x.split(",")),
        default="11,11,3",
    )
    parser.add_argument("--depth_planes", type=int, default=32)
    parser.add_argument("--neighbors", type=int, default=4)
    parser.add_argument(
        "--target_distribution_factory",
        choices=["dirac", "gaussian", "guassian"],  # ref spells "guassian"
        default="dirac",
    )
    parser.add_argument("--stddev_factor", type=float, default=1.0)
    parser.add_argument("--std_is_distance", action="store_true")
    parser.add_argument("--expand_patch", action="store_true")
    parser.add_argument(
        "--sampling_policy",
        choices=[
            "sample_in_disparity",
            "sample_in_bbox",
            "sample_in_range",
            "sample_in_voxel_space",
            "tf_sample_in_bbox",
            "tf_sample_in_range",
            "full_tf_sample_in_bbox",
            "full_tf_sample_in_range",
        ],
        default="sample_in_bbox",
    )
    parser.add_argument(
        "--depth_range",
        type=lambda x: tuple(float(v) for v in x.split(",")),
        default="3.0,7.0",
    )
    parser.add_argument(
        "--grid_shape",
        type=lambda x: tuple(int(v) for v in x.split(",")),
        default="256,256,128",
    )
    parser.add_argument(
        "--maximum_number_of_marched_voxels", type=int, default=650
    )


def add_dataset_related_arguments(parser):
    parser.add_argument(
        "--select_neighbors_based_on",
        choices=["filesystem", "distance"],
        default="filesystem",
    )
    parser.add_argument(
        "--illumination_condition",
        choices=[
            "max", "0_r5000", "1_r5000", "2_r5000", "3_r5000", "4_r5000",
            "5_r5000", "6_r5000",
        ],
        default="max",
    )
    parser.add_argument(
        "--dataset_type", choices=["restrepo", "dtu"], default="restrepo"
    )


def add_mrf_related_arguments(parser):
    parser.add_argument("--initial_gamma_prior", type=float, default=0.05)
    parser.add_argument("--bp_iterations", type=int, default=3)


def add_indexing_related_arguments(parser):
    parser.add_argument(
        "--start_end",
        type=lambda x: tuple(int(v) for v in x.split(",")),
        default="0,5",
    )
    parser.add_argument("--skip_every", type=int, default=0)


def add_forward_pass_factory_related_arguments(parser):
    parser.add_argument(
        "--forward_pass_factory",
        choices=[
            "multi_view_cnn",
            "multi_view_cnn_voxel_space",
            "hartmann_fp",
            "raynet",
            "mvsnet",
            "casmvsnet",
        ],
        default="multi_view_cnn",
    )
    parser.add_argument("--rays_batch", type=int, default=130000)


def add_metrics_related_arguments(parser):
    parser.add_argument("--borders", default=40, type=int)
    parser.add_argument("--truncate", default=float("inf"), type=float)
    parser.add_argument("--min_distance", default=-1, type=float)
    parser.add_argument("--consistency_threshold", default=0.75, type=float)
    parser.add_argument("--n_neighbors", default=5, type=int)
    parser.add_argument("--with_consistency_check", action="store_true")


def add_device_arguments(parser):
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
             "PyTorch versions of the kernels)",
    )


def get_actual_sampling_policy(name):
    """The two sampling policies that ``name`` is a variant of."""
    if "sample_in_bbox" in name:
        return "sample_in_bbox"
    if "sample_in_range" in name:
        return "sample_in_range"
    raise NotImplementedError("unsupported sampling policy %r" % (name,))


def get_input_output_shapes(name):
    return {
        "default": default_input_output_shape,
        "hartmann": hartmann_input_output_shape,
        "reference_wrt_others": reference_wrt_others_input_output_shape,
    }[name]


def get_sample_generator(name):
    return {
        "default": DefaultSampleGenerator,
        "hartmann": HartmannSampleGenerator,
        "reference_wrt_others": CompareWithReferenceSampleGenerator,
    }[name]


def default_input_output_shape(generation_params):
    n = generation_params.neighbors
    d = generation_params.depth_planes
    n_pairs = n * (n + 1) // 2
    dims = (d, n_pairs) + tuple(generation_params.patch_shape)
    return [dims] * 2, [(d,)]


def hartmann_input_output_shape(generation_params):
    n = generation_params.neighbors
    return [tuple(generation_params.patch_shape)] * (n + 1), [(1, 1, 2)]


def reference_wrt_others_input_output_shape(generation_params):
    d = generation_params.depth_planes
    dims = (d, generation_params.neighbors) + tuple(
        generation_params.patch_shape
    )
    return [dims] * 2, [(d,)]


def build_dataset(
    type, dir, illumination_condition, select_neighbors_based_on="filesystem",
    device="cuda",
):
    if type.lower() == "dtu":
        return DTUDataset(
            dir,
            illumination_condition,
            select_neighbors_based_on=select_neighbors_based_on,
            device=device,
        )
    return RestrepoDataset(
        dir, select_neighbors_based_on=select_neighbors_based_on,
        device=device,
    )
