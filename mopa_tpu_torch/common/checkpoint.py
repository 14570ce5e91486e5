"""Checkpoints in the reference's ``.pth`` format (port of
``mopa_tpu/common/checkpoint.py``; reference
``mopa/common/utils/checkpoint.py:12-179``).

A checkpoint is ``<name>.pth``, a ``torch.save`` of ``{'model': ...,
'optimizer': ..., 'scheduler': ..., 'iteration': int, ...}`` whose states
are flat ``name -> numpy array`` dicts in the JAX package's flax names
(``train.trainer.CheckpointAdapter``), so a file written by either package
loads in the other. A ``last_checkpoint<postfix>`` pointer file names the
latest one for AUTO_RESUME; ``CheckpointerV2`` keeps a ring of the last
``max_to_keep`` files in ``checkpoint_ring<postfix>`` and deletes the
oldest.
"""

import logging
import os

import numpy as np
import torch

from mopa_tpu_torch.common.io_utils import get_md5


def _to_numpy_tree(obj):
    """Recursively convert tensors (and other array-likes) to numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "__array__") and not isinstance(obj, np.ndarray):
        return np.asarray(obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


class Checkpointer(object):
    """Save/load checkpoints with a ``last_checkpoint`` pointer file."""

    _last_checkpoint_name = "last_checkpoint"

    def __init__(self, state_provider=None, save_dir="", logger=None,
                 postfix=""):
        """``state_provider`` has ``state_dict() -> dict`` and
        ``load_state_dict(dict, resume_states: bool) -> dict`` (the train
        state's ``CheckpointAdapter``)."""
        self.state_provider = state_provider
        self.save_dir = save_dir
        self.logger = logger or logging.getLogger(__name__)
        self.postfix = postfix

    def save(self, name, tag=True, **kwargs):
        if not self.save_dir:
            return None
        data = {}
        if self.state_provider is not None:
            data.update(_to_numpy_tree(self.state_provider.state_dict()))
        data.update(kwargs)
        save_file = os.path.join(self.save_dir, "{}.pth".format(name))
        self.logger.info("Saving checkpoint to {}".format(save_file))
        # protocol 4 pickles each numpy array's buffer as it is (protocol 2,
        # torch.save's default, copies it through a bytes object: 4x
        # slower for the 2D stream); torch.load reads both
        torch.save(data, save_file, pickle_protocol=4)
        if tag:
            self.tag_last_checkpoint(save_file)
        return save_file

    def load(self, path=None, resume=True, resume_states=True):
        if resume and self.has_checkpoint():
            path = self.get_checkpoint_file()
        if not path:
            self.logger.info(
                "No checkpoint found. Initializing model from scratch")
            return {}
        self.logger.info("Loading checkpoint from {}, MD5: {}".format(
            path, get_md5(path)))
        checkpoint = self._load_file(path)
        if self.state_provider is not None:
            checkpoint = self.state_provider.load_state_dict(
                checkpoint, resume_states=resume_states)
        return checkpoint

    def _load_file(self, path):
        return _to_numpy_tree(torch.load(path, map_location="cpu",
                                         weights_only=False))

    def has_checkpoint(self):
        return os.path.exists(self._pointer_path())

    def get_checkpoint_file(self):
        """The file the pointer names ('' for an empty pointer)."""
        with open(self._pointer_path(), "r") as f:
            last_saved = f.read().strip()
        if last_saved and not os.path.isabs(last_saved):
            last_saved = os.path.join(self.save_dir, last_saved)
        return last_saved

    def tag_last_checkpoint(self, last_filename):
        with open(self._pointer_path(), "w") as f:
            f.write(os.path.basename(last_filename))

    def _pointer_path(self):
        return os.path.join(self.save_dir,
                            self._last_checkpoint_name + self.postfix)


class CheckpointerV2(Checkpointer):
    """Adds a ``max_to_keep`` ring of the tagged checkpoints (reference
    checkpoint.py:121-179); 0 keeps every file."""

    def __init__(self, state_provider=None, save_dir="", logger=None,
                 postfix="", max_to_keep=5):
        super().__init__(state_provider, save_dir, logger, postfix)
        self.max_to_keep = max_to_keep
        self._last_checkpoints = []
        self._restore_ring()

    def _ring_path(self):
        return os.path.join(self.save_dir, "checkpoint_ring" + self.postfix)

    def _restore_ring(self):
        if not os.path.exists(self._ring_path()):
            self._last_checkpoints = []
            return
        with open(self._ring_path(), "r") as f:
            self._last_checkpoints = [ln.strip() for ln in f if ln.strip()]

    def _persist_ring(self):
        with open(self._ring_path(), "w") as f:
            f.write("\n".join(self._last_checkpoints))

    def save(self, name, tag=True, **kwargs):
        save_file = super().save(name, tag=tag, **kwargs)
        if save_file is None or not tag:
            return save_file
        if save_file in self._last_checkpoints:
            self._last_checkpoints.remove(save_file)
        self._last_checkpoints.append(save_file)
        while 0 < self.max_to_keep < len(self._last_checkpoints):
            victim = self._last_checkpoints.pop(0)
            if os.path.exists(victim):
                os.remove(victim)
        self._persist_ring()
        return save_file
