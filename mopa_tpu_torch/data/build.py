"""Datasets and loaders (port of ``mopa_tpu/data/build.py``).

``build_dataloader`` builds the dataset that ``DATASET_{SOURCE,TARGET}.TYPE``
names, strips augmentation for eval, gates the MoPA-only inputs (VGI
objects, SAM masks, ground indices, the EMA teacher's view) to target-domain
training, wraps training in the resumable iteration sampler and collates
padded numpy batches (``data.collate.collate_padded``) with the loader's
host work: key-sorted train points, host VGI on the target stream of a MoPA
run and the host-built voxel plans. Eval batches keep dataset order; the
port's eval plan sorts its points itself (``ops.voxel.voxelize``).

``DataLoader`` reads the samples of a batch on a pool of ``num_workers``
threads and collates on one producer thread, ``PREFETCH`` batches ahead of
the consumer; an exception in either reaches the consumer, and a consumer
that stops early stops the producer.

Data parallelism: with a ``mesh`` (``parallel.mesh.DataMesh``) each rank
loads the rank-th of ``mesh.size`` contiguous blocks of every sampled batch,
the samples that device r of the JAX package's one-host mesh steps on
(``P("data")`` splits the global batch so), so ``TRAIN.BATCH_SIZE`` stays
the global batch and the batch-norm statistics of each rank see the same
samples as JAX's shard r. (The JAX package's loader slices
``indices[process::processes]``, which is its split across hosts, each of
which then shards its slice over its own devices.) Every rank's sampler has
the same seed, so the blocks are disjoint. Each rank's host VGI draws from
its own copy of the loader's seeded stream over its own block, where JAX's
one host draws one stream over the whole batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from mopa_tpu_torch.common.run_ahead import run_ahead
from mopa_tpu_torch.common.sampler import IterationBasedBatchSampler
from mopa_tpu_torch.data.a2d2.a2d2_dataloader import A2D2SCN
from mopa_tpu_torch.data.collate import collate_padded
from mopa_tpu_torch.data.nuscenes.nuscenes_dataloader import NuScenesSCN
from mopa_tpu_torch.data.semantic_kitti.semantic_kitti_dataloader import \
    SemanticKITTISCN
from mopa_tpu_torch.data.synthetic import SyntheticSCN
from mopa_tpu_torch.models.build import plan_levels
from mopa_tpu_torch.parallel.mesh import shard_range

PREFETCH = 2        # batches the producer collates ahead of its consumer
AUDIT_BATCHES = 2   # batches of each pass that carry the capacity audit

DATASET_TYPES = {
    "NuScenesSCN": NuScenesSCN,
    "A2D2SCN": A2D2SCN,
    "SemanticKITTISCN": SemanticKITTISCN,
    "SyntheticSCN": SyntheticSCN,
}

# per-sample point budgets when TPU.POINT_BUDGET is 0 (points after the
# camera's view and the crop, per dataset)
DEFAULT_POINT_BUDGET = {
    "NuScenesSCN": 4096,
    "A2D2SCN": 16384,
    "SemanticKITTISCN": 16384,
    "SyntheticSCN": 4096,
}

# the target-domain inputs of MoPA, dropped from every other real loader
_MOPA_KEYS = ("use_pc_mm", "multi_objs", "obj_name_ls", "obj_root_dir",
              "z_disc", "sc_rotation", "sam_mask_dir", "g_indices_dir",
              "ema_input", "ps_label_dir", "pselab_paths")


def point_budget_for(cfg, dataset_type):
    budget = int(cfg.TPU.POINT_BUDGET) if "TPU" in cfg else 0
    return budget or DEFAULT_POINT_BUDGET.get(dataset_type, 16384)


class DataLoader:
    """Iterable over padded batches, collated :data:`PREFETCH` ahead on a
    producer thread whose samples load on a pool of ``num_workers``
    threads (in the caller's thread at 0). The first
    :data:`AUDIT_BATCHES` batches of each pass carry the capacity
    audits. With ``mesh`` each batch is this rank's block of the sampled
    one."""

    def __init__(self, dataset, batch_sampler, point_budget, mask_budget=64,
                 num_workers=0, sort_points=False,
                 host_plan_capacities=None, vgi_host=None, mesh=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.point_budget = point_budget
        self.mask_budget = mask_budget
        self.sort_points = sort_points
        self.host_plan_capacities = host_plan_capacities
        if vgi_host is not None and "rng" not in vgi_host:
            # one VGI stream per loader: batches collate one after another
            # on the producer, so the draws follow the seed
            vgi_host = dict(vgi_host)
            vgi_host["rng"] = np.random.default_rng(
                int(vgi_host.get("seed", 0)))
        self.vgi_host = vgi_host
        self.num_workers = num_workers
        self.mesh = mesh

    def _host_slice(self, indices):
        """This rank's block of a sampled batch (all of it without a
        mesh)."""
        indices = np.asarray(indices)
        if self.mesh is None:
            return indices
        lo, hi = shard_range(len(indices), self.mesh)
        return indices[lo:hi]

    def _load_batch(self, indices, pool=None, audit=True):
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, indices))
        else:
            samples = [self.dataset[i] for i in indices]
        return collate_padded(samples, self.point_budget,
                              mask_budget=self.mask_budget,
                              sort_points=self.sort_points,
                              host_plan_capacities=self.host_plan_capacities,
                              vgi_host=self.vgi_host, audit=audit)

    def __iter__(self):
        if self.num_workers <= 0:
            for bi, indices in enumerate(self.batch_sampler):
                yield self._load_batch(self._host_slice(indices),
                                       audit=bi < AUDIT_BATCHES)
            return

        def produce(put):
            with ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="mopa-loader-pool") as pool:
                for bi, indices in enumerate(self.batch_sampler):
                    if not put(self._load_batch(self._host_slice(indices),
                                                pool,
                                                audit=bi < AUDIT_BATCHES)):
                        return

        yield from run_ahead(produce, PREFETCH, "mopa-loader")

    def __len__(self):
        return len(self.batch_sampler)


def build_dataloader(cfg, mode="train", domain="source", start_iteration=0,
                     want_ema=None, mesh=None):
    """The loader of ``domain`` ("source" or "target") in ``mode`` ("train",
    "val" or "test"). ``want_ema=False`` leaves out the EMA teacher's inputs
    (its view, ``ema_map`` and the ``hp_ori_*`` plans), which the steps
    before ``ema_start_iter`` never read; the train loop rebuilds the target
    loader with ``want_ema=True`` at the switch. None keeps what the config
    asks for. ``start_iteration`` resumes the sampler. With ``mesh`` the
    loader yields this rank's block of each batch."""
    assert mode in ("train", "val", "test")
    dataset_cfg = cfg.get("DATASET_" + domain.upper())
    split = dataset_cfg[mode.upper()]
    is_train = mode == "train"
    batch_size = cfg.TRAIN.BATCH_SIZE if is_train else cfg.VAL.BATCH_SIZE

    dataset_kwargs = dict(dataset_cfg.get(dataset_cfg.TYPE, {}))
    # the dataset's input format follows the 3D backbone
    dataset_kwargs.setdefault("backbone", cfg.MODEL_3D.TYPE)
    # depth labels feed the source stream's depth head
    if (bool(cfg.TRAIN.get("DEPTH_PRED", False)) and is_train
            and domain == "source"):
        dataset_kwargs["with_depth_label"] = True
    aug = dict(dataset_kwargs.pop("augmentation", {}))
    if is_train:
        dataset_kwargs.update(aug)
    if want_ema is False:
        dataset_kwargs.pop("ema_input", None)
        dataset_kwargs.pop("with_ema", None)

    if dataset_cfg.TYPE != "SyntheticSCN":
        # the MoPA inputs exist for target-domain training only
        if not (is_train and domain == "target"):
            for key in _MOPA_KEYS:
                dataset_kwargs.pop(key, None)
        else:
            dataset_kwargs.pop("pselab_paths", None)
        if "SCN" in cfg.MODEL_3D.keys() and "full_scale" in dataset_kwargs:
            assert dataset_kwargs["full_scale"] == cfg.MODEL_3D.SCN.full_scale
        if "ema_input" in dataset_kwargs and not dataset_kwargs["ema_input"]:
            dataset_kwargs.pop("ema_input")

    dataset_cls = DATASET_TYPES[dataset_cfg.TYPE]
    if dataset_cfg.TYPE == "A2D2SCN":
        dataset = dataset_cls(split=tuple(split), **dataset_kwargs)
    else:
        dataset = dataset_cls(split=tuple(split), output_orig=not is_train,
                              **dataset_kwargs)

    if is_train:
        sampler = IterationBasedBatchSampler(
            len(dataset), batch_size, cfg.SCHEDULER.MAX_ITERATION,
            start_iter=start_iteration, shuffle=True,
            drop_last=cfg.DATALOADER.DROP_LAST, seed=cfg.RNG_SEED)
    else:
        n_batches = (len(dataset) + batch_size - 1) // batch_size
        order = np.arange(len(dataset))
        sampler = [order[i * batch_size:(i + 1) * batch_size]
                   for i in range(n_batches)]

    budget = point_budget_for(cfg, dataset_cfg.TYPE)
    # train batches: key-sorted points and host-built plans of the voxel
    # backbones (as many levels as the 3D net's plan; none for SalsaNext's
    # range images); host VGI on the target stream of a MoPA run
    host_caps = vgi_host = None
    levels = plan_levels(cfg)
    if is_train and levels is not None:
        from mopa_tpu_torch.models.scn_unet import capacity_schedule

        factors = tuple(cfg.TPU.get("CAP_FACTORS", ())) or None
        host_caps = capacity_schedule(budget, levels, factors=factors)
        if (domain == "target"
                and float(cfg.TRAIN.PC_MM.lambda_pc_mm) > 0):
            dkw = dataset_cfg.get(dataset_cfg.TYPE, {})
            vgi_host = {
                "pc_mm": cfg.TRAIN.PC_MM,
                "aug": dict(dkw.get("augmentation", {})),
                "scale": float(dkw.get("scale", 20)),
                "full_scale": int(dkw.get("full_scale", 4096)),
                "front_axis_x": ("SEMANTICKITTI" in dataset_cfg.TYPE.upper()
                                 or dataset_cfg.TYPE == "SyntheticSCN"),
                "num_levels": levels,
                "factors": factors,
                "seed": int(cfg.RNG_SEED) if cfg.RNG_SEED >= 0 else 0,
            }
    return DataLoader(dataset, sampler, budget,
                      mask_budget=int(cfg.TPU.SAM_MASK_BUDGET),
                      num_workers=cfg.DATALOADER.NUM_WORKERS,
                      sort_points=is_train, host_plan_capacities=host_caps,
                      vgi_host=vgi_host, mesh=mesh)
