"""Checkpoint and resume of training states, on ``torch.save``.

Port of ``raynet_tpu/train/checkpointing.py`` (orbax there): the same API
(``save``, ``restore``, ``latest_step``, ``wait``, ``close``,
``save_interval_steps``, ``max_to_keep``) and layout, one directory per
step under ``directory``. A state is anything with ``state_dict()`` and
``load_state_dict()``; ``train.pretrain.PretrainState`` saves the
parameters, the BatchNorm running statistics, the optimizer's moments and
its step count, so an interrupted run resumes exactly.
"""
import os
import shutil

import torch

_FILE = "state.pt"


class CheckpointManager:
    """Save every ``save_interval_steps`` steps, keep the last
    ``max_to_keep``, resume from the latest."""

    def __init__(self, directory, save_interval_steps=500, max_to_keep=3):
        self._directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        os.makedirs(self._directory, exist_ok=True)

    def all_steps(self):
        return sorted(
            int(d) for d in os.listdir(self._directory)
            if d.isdigit()
            and os.path.isfile(os.path.join(self._directory, d, _FILE))
        )

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, state, force=False):
        """Write ``state`` as step ``step`` (every ``save_interval_steps``
        steps, or always with ``force``); returns whether it did."""
        if not force and step % self.save_interval_steps:
            return False
        final = os.path.join(self._directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state.state_dict(), os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._directory, str(old)))
        return True

    def restore(self, state_template, step=None):
        """Load the checkpoint of ``step`` (the latest by default) into
        ``state_template``. Returns (state, step), or (state_template,
        None) when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state_template, None
        sd = torch.load(os.path.join(self._directory, str(step), _FILE),
                        map_location="cpu", weights_only=True)
        state_template.load_state_dict(sd)
        return state_template, step

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between saves."""
