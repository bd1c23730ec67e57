"""The argparse groups the port's CLIs use.

Same flag names, choices and defaults as ``raynet_tpu/scripts/arguments.py``
(which imports the JAX training code, so the groups are repeated here),
plus ``--device``; ``build_dataset`` gives its scenes that device.
"""
from ..common.dataset import DTUDataset, RestrepoDataset


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
