"""Traffic ``prebuilt_train``: the program's train step driven back to back,
as the train loop drives it (the call, then its metrics copied to the
host), over a pool of distinct (source, target) host batches built in
set-up as the train loaders build them: the configuration's datasets
through the program's collate, key-sorted, with host plans and, for
MoPA, host VGI.

The traffic file gives ``pool`` (batch pairs, cycled), ``with_mopa`` (the
SAM and VGI terms) and ``trace_steps`` (steps of a traced window at most).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import train


def raw_pool(cfg, n: int, seed: int) -> list:
    """``n`` raw (source, target) batch pairs of the configuration's train
    datasets: scans drawn without repeats from the seed, augmented by each
    dataset's own draws, collated at the point budget and key-sorted, with
    no host plan and no VGI yet. The raw VGI scan is float32 in metres."""
    from mopa_tpu_torch.data.build import build_dataloader
    from mopa_tpu_torch.data.collate import collate_padded

    pairs = [[None, None] for _ in range(n)]
    rng = np.random.default_rng([seed, 11])
    for j, domain in enumerate(("source", "target")):
        dl = build_dataloader(cfg, "train", domain, want_ema=False)
        b = int(cfg.TRAIN.BATCH_SIZE)
        order = rng.permutation(len(dl.dataset))
        order = np.resize(order, n * b)
        for i in range(n):
            samples = [dl.dataset[int(k)] for k in order[i * b:(i + 1) * b]]
            raw = collate_padded(samples, dl.point_budget,
                                 mask_budget=dl.mask_budget, sort_points=True,
                                 audit=False)
            if "ori_points" in raw and raw["ori_points"].dtype == np.int16:
                q = raw["ori_points"].astype(np.float32)
                raw["ori_points"] = np.concatenate(
                    [q[..., :3] * 0.005, q[..., 3:] / 32000.0], axis=-1)
            pairs[i][j] = raw
    return [tuple(p) for p in pairs]


def program_batch(cfg, raw: dict, rng) -> dict:
    """The program's loader work on a raw batch: host VGI (with ``rng``)
    where the batch has VGI inputs, then the scans' host plans."""
    from mopa_tpu_torch.data import synthetic
    from mopa_tpu_torch.data.build import build_dataloader

    domain = "target" if "ori_points" in raw else "source"
    dl = build_dataloader(cfg, "train", domain, want_ema=False)
    vgi = None
    if rng is not None and dl.vgi_host is not None:
        vgi = dict(dl.vgi_host, rng=rng)
    batch = {k: (v.copy() if isinstance(v, np.ndarray) else v)
             for k, v in raw.items()}
    return synthetic.add_host_plans(
        batch, {"capacities": dl.host_plan_capacities, "vgi": vgi})


class Driver:
    stages = train.STAGES

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.cell = train.TrainCell(conf, traffic, seed, device)
        self.traffic = traffic
        self.seed = seed
        self.mopa = self.cell.with_mopa

    def _rng(self, i: int):
        return train.vgi_rng(self.seed, i) if self.mopa else None

    def setup(self) -> None:
        c = self.cell
        n = int(self.traffic["pool"])
        with c.phases("raw_pool"):
            self.raw = raw_pool(c.cfg, n, train.seeds(self.seed)["data"])
        with c.phases("host_plans_vgi"):
            self.pool = [(program_batch(c.cfg, s, None),
                          program_batch(c.cfg, t, self._rng(i)))
                         for i, (s, t) in enumerate(self.raw)]
        c.build()
        with c.phases("first_steps"):
            for i in range(train.CHECK_STEPS):
                c.step(*self.pool[i])
            if c.device.type == "cuda":
                torch.cuda.synchronize(c.device)
        self.next = train.CHECK_STEPS
        self.scans = 2 * int(c.cfg.TRAIN.BATCH_SIZE)

    def _run(self, seconds: float, most: int | None = None) -> dict:
        dev = self.cell.device
        t0 = time.perf_counter()
        steps, used = 0, []
        while time.perf_counter() - t0 < seconds and (most is None
                                                      or steps < most):
            i = self.next % len(self.pool)
            self.cell.step(*self.pool[i])
            used.append(i)
            self.next += 1
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {"seconds": time.perf_counter() - t0, "steps": steps,
                "batches": used}

    def window(self, seconds: float) -> dict:
        r = self._run(seconds)
        self.steps = r["steps"]
        return {"train_scans_per_s": r["steps"] * self.scans / r["seconds"]}

    def traced_window(self, seconds: float) -> dict:
        r = self._run(seconds, int(self.traffic["trace_steps"]))
        self.steps = r["steps"]
        return r

    def attempted(self) -> int:
        """Steps of the window (a step that fails ends the run)."""
        return self.steps

    def failed(self) -> int:
        return 0

    def release(self) -> None:
        self.cell.release()
        del self.pool

    @property
    def note(self) -> str:
        return self.cell.phases.line()

    def work(self, info: dict) -> dict:
        """Each count of :meth:`train.TrainCell.step_counts` (least time of
        the K1 / K2 launches, model operations at peak, and the 3D net's
        own) summed over the traced window's steps."""
        per = {}
        total = {}
        for i in info["batches"]:
            if i not in per:
                s, t = self.raw[i]
                per[i] = self.cell.step_counts(s, t, self._rng(i))
            for k, v in per[i].items():
                total[k] = total.get(k, 0.0) + v
        return total

    def check(self, control: bool = False) -> dict:
        """The numbers compared: the program's first steps against the
        reference's; with ``control`` also the control's against it."""
        def pairs():
            return [(s, t, self._rng(i)) for i, (s, t) in
                    enumerate(self.raw[:train.CHECK_STEPS])]
        return train.check_numbers(self.cell, pairs, control)
