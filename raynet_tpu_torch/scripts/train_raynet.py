#!/usr/bin/env python
"""raynet_train_torch: end-to-end training of the full RayNet pipeline.

The PyTorch twin of ``raynet_tpu/scripts/train_raynet.py``: the same
positional arguments, flags and defaults, plus ``--device`` (default
``cuda``); a manual iteration loop over single-scene ray batches, the
``validate_every`` / ``snapshot_every`` cadence, the experiment directory's
``train_statistics.txt`` (header ``scene_idx loss gamma``) and
``val_loss.txt`` logs, ``weights/weights.<it>.msgpack`` snapshots and
``weights.final.msgpack`` in the JAX package's flax layout of the CNN
(``--weight_file`` of either package's forward and training CLIs reads
them), checkpoints of the whole state (CNN, BatchNorm statistics, gamma,
optimizer moments and step) every ``--checkpoint_every`` iterations, and
``--resume EXPERIMENT_DIR``, which continues at the saved iteration and
appends to the logs.

Both sample generators draw from one ``np.random.RandomState(--seed)``,
as the JAX CLI's draw from numpy's global generator seeded with
``--seed``; the CNN's initial weights come from a ``torch.Generator``
seeded with ``--seed``. Each iteration prints its seconds of drawing
samples on the host, of finishing them (the batch's voxel traversal, one
launch of K3's rows mode on a card) and of the training step.
"""
import argparse
import os
import time

import numpy as np

from ..common.generation_parameters import GenerationParameters
from ..common.sampling_schemes import make_sampling_scheme
from ..models.convert import write_cnn_weights
from ..train.batch_provider import RayNetBatchProvider
from ..train.checkpointing import CheckpointManager
from ..train.sample import RayNetRandomSampleGenerator, RayNetSampleGenerator
from ..train.train_e2e import build_end_to_end_training
from ..utils.generic_utils import resolve_device
from .arguments import (
    add_dataset_related_arguments,
    add_device_arguments,
    add_generation_arguments,
    add_mrf_related_arguments,
    add_nn_arguments,
    add_training_arguments,
    build_dataset,
    get_input_output_shapes,
)
from .experiments_utils.experiments_manager import set_output_directory


def save_weights(state, path):
    """The state's CNN as the JAX package's weight file."""
    write_cnn_weights(path, state.model.state_dict())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train RayNet end to end (CNN + unrolled MRF-BP)"
    )
    parser.add_argument("training_directory")
    parser.add_argument("test_directory")
    parser.add_argument("output_directory")
    parser.add_argument(
        "--weight_file",
        default=None,
        help="Pretrained CNN weights to start from (msgpack)",
    )
    parser.add_argument("--iterations", type=int, default=100000)
    parser.add_argument("--validate_every", type=int, default=200)
    parser.add_argument("--snapshot_every", type=int, default=500)
    parser.add_argument("--rays_batch_size", type=int, default=1000,
                        help="Rays per training batch")
    parser.add_argument("--n_rays", type=int, default=10000,
                        help="Rays drawn per reference image")
    parser.add_argument("--window", type=int, default=4)
    parser.add_argument("--train_with_gamma", action="store_true")
    parser.add_argument("--seed", type=int, default=27)
    parser.add_argument(
        "--checkpoint_every", type=int, default=500,
        help="Save the whole training state (CNN, BatchNorm statistics, "
             "gamma, optimizer moments and step) every N iterations",
    )
    parser.add_argument(
        "--resume", default=None, metavar="EXPERIMENT_DIR",
        help="Resume an interrupted run from its experiment directory's "
             "latest checkpoint (logs are appended)",
    )
    add_nn_arguments(parser)
    add_training_arguments(parser)
    add_generation_arguments(parser)
    add_dataset_related_arguments(parser)
    add_mrf_related_arguments(parser)
    add_device_arguments(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)

    rng = np.random.RandomState(args.seed)
    if args.resume:
        experiment_dir = args.resume
        weights_dir = os.path.join(experiment_dir, "weights")
        if not os.path.isdir(weights_dir):
            raise SystemExit(
                "--resume %r is not an experiment directory" % (args.resume,)
            )
    else:
        experiment_dir, weights_dir, _ = set_output_directory(
            args.output_directory
        )
    print("experiment directory:", experiment_dir)

    gp = GenerationParameters.from_options(args)
    scheme = make_sampling_scheme(args.sampling_policy, gp,
                                  device=args.device)

    def dataset(directory):
        return build_dataset(args.dataset_type, directory,
                             args.illumination_condition,
                             args.select_neighbors_based_on,
                             device=args.device)

    train_ds = dataset(args.training_directory)
    test_ds = dataset(args.test_directory)

    in_shapes, out_shapes = get_input_output_shapes("default")(gp)
    train_sg = RayNetRandomSampleGenerator(
        scheme, gp, list(range(train_ds.n_scenes)), in_shapes, out_shapes,
        n_rays=args.n_rays, window=args.window, rng=rng, device=args.device,
    )
    test_sg = RayNetSampleGenerator(
        scheme, gp, list(range(test_ds.n_scenes)), in_shapes, out_shapes,
        n_rays=args.n_rays, window=args.window, rng=rng, device=args.device,
    )
    train_bp = RayNetBatchProvider(train_ds, train_sg)
    test_bp = RayNetBatchProvider(test_ds, test_sg)

    print("collecting the validation batch...")
    val_batch = test_bp.get_batch_of_rays(args.rays_batch_size)

    state, train_fn, eval_fn = build_end_to_end_training(
        args.seed,
        gp,
        gp.grid_shape,
        cnn_name=args.cnn_factory,
        loss=args.loss,
        optimizer=args.optimizer,
        lr=args.lr,
        momentum=args.momentum,
        gamma=args.initial_gamma_prior,
        train_with_gamma=args.train_with_gamma,
        bp_iterations=args.bp_iterations,
        weight_file=args.weight_file,
        device=args.device,
    )
    if not args.weight_file:
        print(
            "WARNING: training end-to-end from random CNN weights; the "
            "reference requires a pretrained model here"
        )

    ckpt = CheckpointManager(
        os.path.join(experiment_dir, "checkpoints"),
        save_interval_steps=max(1, args.checkpoint_every),
    )
    state, resumed_step = ckpt.restore(state)
    start_it = 0
    if resumed_step is not None:
        start_it = int(resumed_step)
        print("resumed from checkpoint at iteration %d" % (start_it,))

    mode = "a" if args.resume else "w"
    stats = open(
        os.path.join(experiment_dir, "train_statistics.txt"), mode
    )
    val_log = open(os.path.join(experiment_dir, "val_loss.txt"), mode)
    if start_it == 0:
        print("scene_idx loss gamma", file=stats)

    try:
        for it in range(start_it, args.iterations):
            batch = train_bp.get_batch_of_rays(args.rays_batch_size)
            t0 = time.perf_counter()
            state, metrics = train_fn(state, batch)
            loss, gamma = float(metrics["loss"]), float(metrics["gamma"])
            step_s = time.perf_counter() - t0
            timings = train_bp.timings
            print("iteration %d: drawing samples %.3f s, finishing them "
                  "%.3f s (%d traversal call(s)), the step %.3f s"
                  % (it, timings["draw_s"], timings["finish_s"],
                     timings["finishes"], step_s))
            print("%s %f %f" % (batch["scene_idx"], loss, gamma), file=stats)
            stats.flush()

            if (it + 1) % args.validate_every == 0:
                val = float(eval_fn(state, val_batch)["loss"])
                print("%d %f" % (it, val), file=val_log)
                val_log.flush()
                print("iteration %d: val_loss=%f gamma=%f" % (it, val, gamma))
            if (it + 1) % args.snapshot_every == 0:
                save_weights(
                    state,
                    os.path.join(weights_dir, "weights.%d.msgpack" % (it,)),
                )
            # a no-op except every checkpoint_every iterations
            ckpt.save(it + 1, state)
    except KeyboardInterrupt:
        print("interrupted; saving final weights")
    finally:
        save_weights(state, os.path.join(weights_dir, "weights.final.msgpack"))
        ckpt.wait()
        ckpt.close()
        stats.close()
        val_log.close()


if __name__ == "__main__":
    main()
