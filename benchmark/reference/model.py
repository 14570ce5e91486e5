"""The reference's train step of the xMUDA / MoPA model pair, in plain
PyTorch, from a configuration's JSON values alone.

It takes the raw batches the benchmark handed the program (before any of
the program's own derivations: no host plan, no VGI cat scan) and works out
again what the program derived from them: the voxel levels of every scan
(:mod:`.sparse3d`) and, for MoPA, the VGI cat scans (:mod:`.vgi`, from the
same generator state). It imports nothing of the program.

The train step is the pre-EMA one of ``make_train_step(with_pl=True)``:
one 2D forward over the stacked [source; target] images (two batch-norm
domains), one 3D forward over [source; target; VGI cat] scans (three), the
source CE of both nets, the cross-modal KL on source and target (teachers
detached), the pseudo-label CE, with MoPA the SAM consistency loss on the
target's dense 2D logits and the VGI CE on the cat scans, one backward and
an Adam update of each net.
"""

from __future__ import annotations

import numpy as np
import torch

from . import losses as L
from . import sparse3d as sp
from . import vgi
from .net2d import Conv2d, ConvTranspose2d, Net2DSeg
from .net3d import Net3DSeg

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["TPU"]["COMPUTE_DTYPE"]]


def build_nets(cfg: dict, device) -> tuple:
    """(2D net, 3D net) of ``cfg`` with zero weights, on ``device``."""
    dt = compute_dtype(cfg)
    m2 = cfg["MODEL_2D"]
    output_all = float(cfg["TRAIN"]["PC_MM"]["lambda_sam_cons"]) > 0
    net2d = Net2DSeg(m2["NUM_CLASSES"], m2["DUAL_HEAD"], dt, output_all)
    return net2d.to(device), build_net3d(cfg, device)


def build_net3d(cfg: dict, device) -> Net3DSeg:
    """The 3D net of ``cfg`` (its ``MODEL_3D.TYPE`` built from its
    ``MODEL_3D.<TYPE>`` values) with zero weights, on ``device``."""
    m3 = cfg["MODEL_3D"]
    kind = m3["TYPE"]
    net3d = Net3DSeg(kind, m3.get(kind, {}), m3["NUM_CLASSES"],
                     m3["DUAL_HEAD"], compute_dtype(cfg))
    return net3d.to(device)


def load(net: torch.nn.Module, params: dict) -> None:
    """Copy ``params`` (name -> tensor) into ``net``'s parameters; the two
    name sets must be equal."""
    own = dict(net.named_parameters())
    if set(own) != set(params):
        raise KeyError("parameter names differ: {}".format(
            sorted(set(own) ^ set(params))[:8]))
    with torch.no_grad():
        for k, v in params.items():
            own[k].copy_(v)


def set_rounding(net2d, net3d, rounding: dict) -> None:
    """Round the operands of every GEMM by their dtype: ``rounding`` maps a
    dtype to its rounding (the control's); {} computes as stated."""
    r2d = rounding.get(net2d.net_2d.compute_dtype, sp.identity)
    for mod in net2d.modules():
        if isinstance(mod, (Conv2d, ConvTranspose2d)):
            mod.round_operands = r2d
    net3d.set_rounding(rounding)


def decode(batch: dict, device) -> dict:
    """Tensors of a collated numpy batch: images in [0, 1], integer keys as
    int64, ``point_valid`` from ``num_points``, features as float32."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_") or not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if k in ("img", "ori_img") and t.dtype == torch.uint8:
            t = t.float() / 255.0
        elif k == "feats":
            t = t.float()
        elif not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t
    b, p = out["img_indices"].shape[:2]
    out["point_valid"] = (torch.arange(p, device=device)[None, :]
                          < out["num_points"][:, None])
    if "feats" not in out:
        out["feats"] = torch.ones((b * p, 1), device=device)
    return out


def vgi_cat(cfg: dict, raw_trg: dict, rng: np.random.Generator,
            device) -> dict:
    """The VGI cat scans of a raw target batch (the scan with its
    pseudo labels, the candidate objects, the camera), as tensors."""
    pc = cfg["TRAIN"]["PC_MM"]
    ds = cfg["DATASET_TARGET"]
    dkw = ds[ds["TYPE"]]

    class PcMM(dict):
        __getattr__ = dict.__getitem__

    b = raw_trg["ori_points"].shape[0]
    p = raw_trg["img_indices"].shape[1]
    label = raw_trg.get("ori_pseudo_label_3d",
                        np.full((b, p), -100, np.int32))
    out = vgi.vgi_host_batch(
        raw_trg["ori_points"], raw_trg["ori_points_valid"],
        np.asarray(label).reshape(b, -1).astype(np.int32),
        raw_trg["g_mask"], raw_trg["obj_pc"], raw_trg["obj_valid"],
        raw_trg["obj_label"], raw_trg["proj_matrix"], raw_trg["img_size"],
        rng, pc_mm=PcMM(pc), aug=dict(dkw.get("augmentation", {})),
        scale=float(dkw.get("scale", 20)),
        full_scale=int(dkw.get("full_scale", 4096)), front_axis_x=True)
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in out.items() if k != "inserted"}


def scans_plan(parts: list, num_levels: int) -> sp.Plan:
    """One plan of several groups of scans: ``parts`` holds (coords (S*N,
    3), valid (S*N,), S, domain) per group, the groups in order."""
    coords, valid, sample, doms = [], [], [], []
    base = 0
    for c, v, s, dom in parts:
        n = c.shape[0] // s
        coords.append(c)
        valid.append(v)
        sample.append(base + torch.arange(s, device=c.device)
                      .repeat_interleave(n))
        doms += [dom] * s
        base += s
    return sp.build_plan(torch.cat(coords), torch.cat(sample),
                         torch.cat(valid),
                         torch.tensor(doms, device=coords[0].device),
                         num_levels)


def scans_input(src: dict, trg: dict, cat, num_levels: int) -> tuple:
    """The 3D net's input of a decoded batch pair: (features, plan,
    domains) of the source scans, the target's, and the cat scans of MoPA
    where ``cat`` is given."""
    b = src["img_indices"].shape[0]
    parts = [(src["coords"], src["point_valid"].reshape(-1), b, 0),
             (trg["coords"], trg["point_valid"].reshape(-1), b, 1)]
    feats = [src["feats"], trg["feats"]]
    if cat is not None:
        parts.append((cat["coords"], cat["valid"], b, 2))
        feats.append(torch.ones((cat["valid"].shape[0], 1),
                                device=cat["valid"].device))
    return torch.cat(feats), scans_plan(parts, num_levels), len(parts)


def _class_weights(cfg, device):
    cw = cfg["TRAIN"].get("CLASS_WEIGHTS") or None
    return None if cw is None else torch.tensor(cw, device=device)


def step_losses(cfg: dict, net2d, net3d, src: dict, trg: dict, cat,
                generator) -> torch.Tensor:
    """The total loss of one pre-EMA step (the module docstring)."""
    t = cfg["TRAIN"]
    lam, pc = t["XMUDA"], t["PC_MM"]
    dual = bool(cfg["MODEL_2D"]["DUAL_HEAD"])
    b, p = src["img_indices"].shape[:2]
    n = b * p
    cw = _class_weights(cfg, src["img"].device)
    pl_w = cw if pc.get("use_class_weights", False) else None
    with_mopa = cat is not None or float(pc["lambda_sam_cons"]) > 0

    out2d = net2d(torch.cat([src["img"], trg["img"]]),
                  torch.cat([src["img_indices"], trg["img_indices"]]),
                  torch.cat([src["point_valid"], trg["point_valid"]]),
                  n_domains=2, generator=generator)
    feats, plan, nd = scans_input(src, trg, cat, net3d.num_levels)
    out3d = net3d(feats, plan, nd=nd, generator=generator)

    s2 = {k: v[:n] for k, v in out2d.items() if k != "seg_logit_all"}
    t2 = {k: v[n:] for k, v in out2d.items() if k != "seg_logit_all"}
    s3 = {k: v[:n] for k, v in out3d.items()}
    t3 = {k: v[n:2 * n] for k, v in out3d.items()}
    sv = src["point_valid"].reshape(-1)
    tv = trg["point_valid"].reshape(-1)
    lab = src["seg_label"]
    total = L.cross_entropy(s2["seg_logit"], lab, sv & (lab >= 0), cw) \
        + L.cross_entropy(s3["seg_logit"], lab, sv & (lab >= 0), cw)
    second = "seg_logit2" if dual else "seg_logit"
    for w, a, c, v in ((lam["lambda_xm_src"], s2, s3, sv),
                       (lam["lambda_xm_trg"], t2, t3, tv)):
        if w > 0:
            total = total + w * (
                L.xm_kl(a[second], c["seg_logit"].detach(), v)
                + L.xm_kl(c[second], a["seg_logit"].detach(), v))
    if lam["lambda_pl"] > 0:
        pl2, pl3 = trg["pseudo_label_2d"], trg["pseudo_label_3d"]
        total = total + lam["lambda_pl"] * (
            L.cross_entropy(t2["seg_logit"], pl2, tv & (pl2 >= 0), pl_w)
            + L.cross_entropy(t3["seg_logit"], pl3, tv & (pl3 >= 0), pl_w))
    if with_mopa and float(pc["lambda_sam_cons"]) > 0:
        probs = torch.softmax(out2d["seg_logit_all"][b:], dim=-1)
        total = total + pc["lambda_sam_cons"] * L.mask_consistency(
            probs, trg["sam_mask"], int(cfg["TPU"]["SAM_MASK_BUDGET"]))
    if cat is not None:
        logit = out3d["seg_logit"][2 * n:]
        total = total + pc["lambda_pc_mm"] * L.cross_entropy(
            logit, cat["label"], cat["valid"] & (cat["label"] >= 0), pl_w)
    return total


class Adam:
    """Adam (eps 1e-8, coupled weight decay) over a dict of parameters."""

    def __init__(self, params: dict, lr: float, betas, weight_decay: float):
        self.params = params
        self.lr, self.b1, self.b2 = lr, float(betas[0]), float(betas[1])
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad + self.wd * p if self.wd else p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt() + 1e-8
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_readings(cfg: dict, params_2d: dict, params_3d: dict,
                   pairs: list, dropout_seed: int, device,
                   control=None) -> dict:
    """Run the reference's first ``len(pairs)`` train steps from the seeded
    weights; ``pairs`` holds (raw source, raw target, VGI generator or
    None). Returns each step's total loss, each leaf's first gradient and
    its change after the last step, by name ("2d." / "3d." prefixes).
    ``control`` (a dtype -> rounding map) computes the GEMMs whose operands
    have those dtypes in the lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net2d, net3d = build_nets(cfg, device)
    load(net2d, params_2d)
    load(net3d, params_3d)
    if control is not None:
        set_rounding(net2d, net3d, control)
    net2d.train()
    net3d.train()
    o = cfg["OPTIMIZER"]
    opts = []
    for net, key in ((net2d, "MODEL_2D"), (net3d, "MODEL_3D")):
        sub = o[key]
        opts.append(Adam(dict(net.named_parameters()), float(sub["BASE_LR"]),
                         sub.get("Adam", {}).get("betas", (0.9, 0.999)),
                         float(sub.get("WEIGHT_DECAY", 0.0))))
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    start = {"2d." + k: v.detach().clone() for k, v in params_2d.items()}
    start.update({"3d." + k: v.detach().clone() for k, v in params_3d.items()})
    losses, grads = [], {}
    for i, (raw_src, raw_trg, rng) in enumerate(pairs):
        src, trg = decode(raw_src, device), decode(raw_trg, device)
        cat = vgi_cat(cfg, raw_trg, rng, device) if rng is not None else None
        for net in (net2d, net3d):
            net.zero_grad(set_to_none=True)
        total = step_losses(cfg, net2d, net3d, src, trg, cat, gen)
        total.backward()
        losses.append(float(total.detach()))
        if i == 0:
            for pre, net in (("2d.", net2d), ("3d.", net3d)):
                for k, v in net.named_parameters():
                    grads[pre + k] = (v.grad.detach().clone()
                                      if v.grad is not None
                                      else torch.zeros_like(v))
        for opt in opts:
            opt.step()
        del total, src, trg, cat
    change = {}
    for pre, net in (("2d.", net2d), ("3d.", net3d)):
        for k, v in net.named_parameters():
            change[pre + k] = v.detach() - start[pre + k]
    return {"losses": losses, "grads": grads, "change": change}

