#!/usr/bin/env python
"""raynet_pretrain_torch: pretrain the multi-view patch-similarity CNN.

The PyTorch twin of ``raynet_tpu/scripts/pretrain_network.py``: the same
positional arguments, flags and experiment directory (``train.txt`` /
``val.txt`` metric streams, ``weights/weights.%02d.msgpack`` per epoch in
the JAX package's flax layout, which ``raynet_forward_torch --weight_file``
and the JAX package read, ``checkpoints/<epoch>/``, ``parameters.json`` and
``results.npy``), the ``default``, ``reference_wrt_others`` and
``hartmann`` modes, plus ``--device`` (default ``cuda``).

Randomness comes from ``--seed`` alone: the weights from a
``torch.Generator``, the test set and each epoch's samples and batches
from ``np.random.RandomState`` streams keyed by (seed, epoch), so that
``--resume`` from an epoch's checkpoint (parameters, BatchNorm statistics,
optimizer moments and step) replays the later epochs of an uninterrupted
run (on a CUDA device cuDNN is held to its deterministic algorithms for
that). Unlike the JAX package's, the ``hartmann`` mode checkpoints and
resumes too. Each epoch prints its steps per second, and the seconds
spent waiting for samples against the seconds of the steps.
"""
import argparse
import os
import time

import numpy as np
import torch

from ..common.generation_parameters import GenerationParameters
from ..common.sampling_schemes import make_sampling_scheme
from ..models.convert import (
    flax_from_hartmann_state_dict,
    flax_from_similarity_state_dict,
    read_flax_msgpack,
    similarity_state_dict_from_flax,
    write_flax_msgpack,
)
from ..train.batch_provider import BatchProvider
from ..train.checkpointing import CheckpointManager
from ..train.pretrain import (
    create_hartmann_pretrain_state,
    create_pretrain_state,
    make_pretrain_step,
)
from ..utils.generic_utils import resolve_device
from .arguments import (
    add_dataset_related_arguments,
    add_device_arguments,
    add_experiments_related_arguments,
    add_generation_arguments,
    add_hartmann_related_arguments,
    add_nn_arguments,
    add_training_arguments,
    build_dataset,
    get_input_output_shapes,
    get_sample_generator,
)
from .experiments_utils.experiments_manager import (
    MetricsHistory,
    register_experiment,
    save_experiment_locally,
    set_output_directory,
)


def _rng(*key):
    """The ``np.random.RandomState`` stream of ``key`` (seed, ...)."""
    return np.random.RandomState(list(key))


def collect_test_set(dataset, sample_generator, n_samples, batch_size, rng):
    """Materialize a fixed validation set through a short-lived provider."""
    bp = BatchProvider(dataset, sample_generator,
                       cache_size=max(n_samples, batch_size),
                       batch_size=n_samples, rng=rng)
    try:
        return bp.get_batch()
    finally:
        bp.stop()


def lr_schedule(lr, factor, reductions, steps_per_epoch):
    """``lr`` divided by ``factor`` at each epoch in ``reductions``, as a
    callable of the step (float32, as the JAX package's schedule); ``lr``
    itself without ``factor``."""
    if factor is None:
        return lr
    boundaries = np.array([e * steps_per_epoch for e in reductions])

    def inner(step):
        drops = np.float32((step >= boundaries).sum())
        return float(np.float32(lr) * np.float32(factor) ** -drops)

    return inner


class _Run:
    """What both training loops share: the experiment's directories, the
    sample generators, the checkpoints and the metric logs."""

    def __init__(self, args, generation_params, train_ds, experiment_dir,
                 weights_dir):
        self.args = args
        self.train_ds = train_ds
        self.weights_dir = weights_dir
        self.scheme = make_sampling_scheme(
            args.sampling_policy, generation_params, device=args.device)
        self.gp = generation_params
        mode = args.input_output_dimensionality
        self.in_shapes, self.out_shapes = get_input_output_shapes(mode)(
            generation_params)
        self.sg_cls = get_sample_generator(mode)
        self.ckpt = CheckpointManager(
            os.path.join(experiment_dir, "checkpoints"),
            save_interval_steps=1)
        self.history = MetricsHistory(
            os.path.join(experiment_dir, "train.txt"),
            os.path.join(experiment_dir, "val.txt"),
            mode="a" if args.resume else "w",
        )

    def generator(self, dataset, rng):
        return self.sg_cls(self.scheme, self.gp,
                           list(range(dataset.n_scenes)), self.in_shapes,
                           self.out_shapes, rng=rng)

    def restore(self, state):
        state, resumed = self.ckpt.restore(state)
        start = 0 if resumed is None else int(resumed)
        if resumed is not None:
            print("resumed from checkpoint after epoch %d" % (start - 1,))
        return state, start

    def batches(self, epoch):
        """This epoch's provider: its samples and batch indices drawn from
        the (seed, epoch) streams."""
        seed = self.args.seed
        return BatchProvider(
            self.train_ds, self.generator(self.train_ds, _rng(seed, epoch, 0)),
            cache_size=self.args.training_cached_samples,
            batch_size=self.args.batch_size, rng=_rng(seed, epoch, 1))

    def train_epoch(self, epoch, step):
        """One epoch of ``step(X, y) -> metrics`` on this epoch's batches,
        each step's metrics logged; returns the last step's. Prints the
        epoch's steps/s after its sample cache is filled, split into the
        seconds spent in ``get_batch`` (which waits for ``batch_size``
        fresh samples from the host's producer) and the seconds of the
        steps themselves (reading the metrics syncs the device): the
        second rate is the step's own."""
        provider = self.batches(epoch)
        steps = self.args.steps_per_epoch
        waiting = stepping = 0.0
        try:
            provider.ready()
            for _ in range(steps):
                t0 = time.perf_counter()
                X, y = provider.get_batch()
                t1 = time.perf_counter()
                metrics = {k: float(v) for k, v in step(X, y).items()}
                t2 = time.perf_counter()
                self.history.on_batch_end(metrics)
                waiting += t1 - t0
                stepping += t2 - t1
        finally:
            provider.stop()
        print("epoch %d: %d steps in %.3f s (%.2f steps/s, the sample cache "
              "filled before); waiting for samples %.3f s, training steps "
              "%.3f s (%.2f steps/s of the step alone)"
              % (epoch, steps, waiting + stepping,
                 steps / (waiting + stepping), waiting, stepping,
                 steps / stepping))
        return metrics

    def end_epoch(self, epoch, state, val, tree):
        self.history.on_epoch_end(epoch, val)
        write_flax_msgpack(
            os.path.join(self.weights_dir, "weights.%02d.msgpack" % (epoch,)),
            tree)
        self.ckpt.save(epoch + 1, state, force=True)

    def close(self):
        self.ckpt.wait()
        self.ckpt.close()
        self.history.close()


def _hartmann_loop(run, experiment_dir):
    """Hartmann-baseline pretraining: quintuple patches, 2-way CE; the
    epoch's "val_loss" is its last training loss, as in the JAX package."""
    args = run.args
    model, state, train_step = create_hartmann_pretrain_state(
        args.seed, tuple(run.gp.patch_shape),
        n_views=run.gp.neighbors + 1, optimizer=args.optimizer, lr=args.lr,
        momentum=args.momentum, device=args.device,
    )
    state, start_epoch = run.restore(state)
    try:
        for epoch in range(start_epoch, args.epochs):
            # (B, V, ph, pw, C) quintuples
            metrics = run.train_epoch(epoch, lambda X, y: train_step(
                state, np.stack(X, axis=1), y[0])[1])
            run.end_epoch(epoch, state, {"val_loss": metrics["loss"]},
                          flax_from_hartmann_state_dict(model.state_dict()))
    finally:
        run.close()
    save_experiment_locally(experiment_dir, vars(args), [])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=(
            "Pretrain the CNN that scores multi-view patch similarity "
            "for per-pixel depth distributions"
        )
    )
    parser.add_argument(
        "training_directory", help="Directory with the training scenes"
    )
    parser.add_argument(
        "test_directory", help="Directory with the test scenes"
    )
    parser.add_argument(
        "output_directory", help="Directory to save experiments"
    )
    parser.add_argument("--weight_file", default=None)
    parser.add_argument(
        "--input_output_dimensionality",
        choices=["default", "hartmann", "reference_wrt_others"],
        default="default",
    )
    parser.add_argument("--seed", type=int, default=27)
    parser.add_argument(
        "--resume", default=None, metavar="EXPERIMENT_DIR",
        help="Resume an interrupted run from its experiment directory's "
             "latest checkpoint (full state: parameters, optimizer moments "
             "and step, BatchNorm statistics; logs are appended)",
    )
    add_nn_arguments(parser)
    add_training_arguments(parser)
    add_generation_arguments(parser)
    add_experiments_related_arguments(parser)
    add_hartmann_related_arguments(parser)
    add_dataset_related_arguments(parser)
    add_device_arguments(parser)
    args = parser.parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

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

    generation_params = GenerationParameters.from_options(args)

    def dataset(directory):
        return build_dataset(args.dataset_type, directory,
                             args.illumination_condition,
                             args.select_neighbors_based_on,
                             device=args.device)

    train_ds, test_ds = (dataset(args.training_directory),
                         dataset(args.test_directory))
    run = _Run(args, generation_params, train_ds, experiment_dir,
               weights_dir)

    print("collecting the test set (%d samples)..." % (args.n_test_samples,))
    test_X, test_y = collect_test_set(
        test_ds, run.generator(test_ds, _rng(args.seed)),
        args.n_test_samples, args.batch_size, _rng(args.seed, 1))

    if args.input_output_dimensionality == "hartmann":
        return _hartmann_loop(run, experiment_dir)

    model, state, loss_fn, wd = create_pretrain_state(
        args.seed,
        run.in_shapes[0],
        cnn_name=args.cnn_factory,
        optimizer=args.optimizer,
        lr=lr_schedule(
            args.lr, args.lr_factor, args.lr_epochs, args.steps_per_epoch
        ),
        momentum=args.momentum,
        loss=args.loss,
        reducer=args.reducer,
        merge_layer=args.merge_layer,
        weight_decay=args.weight_decay,
        device=args.device,
    )
    if args.weight_file:
        model.load_state_dict(
            similarity_state_dict_from_flax(read_flax_msgpack(args.weight_file)))
    train_step, eval_step = make_pretrain_step(model, loss_fn, wd)
    state, start_epoch = run.restore(state)

    results = []
    try:
        for epoch in range(start_epoch, args.epochs):
            run.train_epoch(epoch, lambda X, y: train_step(
                state, X[0], X[1], y[0])[1])
            val = eval_step(state, test_X[0], test_X[1], test_y[0])
            val = {"val_%s" % k: float(v) for k, v in val.items()}
            print("epoch %d:" % epoch, val)
            results.append([val["val_loss"], val["val_acc"], val["val_mde"]])
            run.end_epoch(epoch, state, val, flax_from_similarity_state_dict(
                model.state_dict(), args.cnn_factory))
    except KeyboardInterrupt:
        print("interrupted; saving results so far")
    finally:
        run.close()

    save_experiment_locally(
        experiment_dir, vars(args), np.array(results, dtype=np.float32)
    )
    register_experiment(
        args.credentials, args.spreadsheet, vars(args), results,
        fallback=os.path.join(args.output_directory, "experiments.jsonl"),
    )


if __name__ == "__main__":
    main()
