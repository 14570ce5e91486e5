"""Point Transformer V3 of the port (``mopa_tpu_torch.models.ptv3`` over the
plan that ``models.serialize`` serializes) against the benchmark's plain
reference (``benchmark/reference/nets3d/ptv3.py``), in float32 on the CPU
at the reference's ``small()`` widths with its seeded weights:

* the curves: Z-order is the bit interleave, Hilbert walks a cube through
  face neighbours, the port's codes are Pointcept's (the reference's), and
  a child's code >> 3 is its parent's at every level;
* the patch layout is Pointcept's padding rule on hand-made counts, and the
  reference's;
* the plan: the port's level coordinates and 5x5x5 stem map are the
  reference's;
* the net: its output and every parameter's gradient within written
  tolerances of the reference's, in train mode (one generator's draws,
  drop path on, two batch-norm domains) and in eval mode; the same with
  the attention's operands cast to bfloat16 falls outside them;
* ``train()`` trains it and validates it with no other script.
"""

import logging
import statistics

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import weights
from benchmark.reference import sparse3d as sp
from benchmark.reference.nets3d import ptv3 as ref
from mopa_tpu_torch.models import ptv3
from mopa_tpu_torch.models import serialize as ser
from mopa_tpu_torch.models.scn_unet import build_unet_plan_batched

SCANS, POINTS, LEVELS = 4, 600, 5
DOMAINS = [0, 0, 1, 1]
# float32 on both sides: the point features agree to 3e-6 of their norm,
# the worst leaf's gradient to 6e-5 of the median leaf's (measured); the
# attention in bfloat16 reads 2e-3 / 0.09 and more
OUT_TOL = 1e-4
GRAD_TOL = 1e-3


def scans(seed: int) -> tuple:
    """(coords (S, P, 3), valid (S, P), feats (S*P, 4)) of scans whose
    points lie on a sloped surface, so that voxels have neighbours."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.randint(0, 48, (SCANS, POINTS, 2), generator=g)
    z = xy.sum(-1, keepdim=True) // 6 \
        + torch.randint(0, 2, (SCANS, POINTS, 1), generator=g)
    valid = torch.rand(SCANS, POINTS, generator=g) > 0.05
    feats = torch.randn(SCANS * POINTS, 4, generator=g)
    return torch.cat([xy, z], dim=-1), valid, feats


def plans(seed: int, values: dict) -> tuple:
    """(the port's serialized plan, the reference's plan, features)."""
    coords, valid, feats = scans(seed)
    plan = build_unet_plan_batched(coords, valid, LEVELS,
                                   capacities=[POINTS] * LEVELS,
                                   sample_domains=DOMAINS)
    plan = plan._replace(serial=ser.serialize(
        plan, coords.reshape(-1, 3), SCANS, values["enc_patch_size"],
        values["order"]))
    mine = sp.build_plan(coords.reshape(-1, 3),
                         torch.arange(SCANS).repeat_interleave(POINTS),
                         valid.reshape(-1), torch.tensor(DOMAINS), LEVELS)
    return plan, mine, feats


def valid_rows(plan, l: int, t: torch.Tensor) -> torch.Tensor:
    """``t``'s rows at level ``l``'s valid slots, in slot order (the
    reference's voxel order: slots are sample-major and key-sorted)."""
    return t[plan.levels[l].valid]


# -- curves ------------------------------------------------------------------

def test_z_order_is_the_bit_interleave():
    c = torch.randint(0, 4096, (300, 3), generator=torch.Generator()
                      .manual_seed(0))
    want = [sum((((x >> b) & 1) << (3 * b + 2)) | (((y >> b) & 1)
                                                   << (3 * b + 1))
                | (((z >> b) & 1) << (3 * b)) for b in range(12))
            for x, y, z in c.tolist()]
    assert ser.z_order(c, 12).tolist() == want
    assert ser.curve_code(c, "z-trans", 12).tolist() == \
        ser.z_order(c[:, [1, 0, 2]], 12).tolist()


@pytest.mark.parametrize("order", ["hilbert", "hilbert-trans"])
def test_hilbert_walks_a_cube_by_face_neighbours(order):
    r = torch.arange(8)
    cube = torch.cartesian_prod(r, r, r)
    code = ser.curve_code(cube, order, 3)
    assert sorted(code.tolist()) == list(range(512))
    walk = cube[torch.argsort(code)]
    assert torch.equal((walk[1:] - walk[:-1]).abs().sum(dim=1),
                       torch.ones(511, dtype=torch.long))


@pytest.mark.parametrize("order", ser.ORDERS)
def test_codes_are_pointcepts(order):
    """The port's integer form of each curve against the reference's
    transcription of Pointcept's (bit arrays for Hilbert), scan index
    above."""
    g = torch.Generator().manual_seed(1)
    c = torch.randint(0, 4096, (500, 3), generator=g)
    sample = torch.randint(0, 16, (500,), generator=g)
    got = (sample << 36) | ser.curve_code(c, order, 12)
    assert torch.equal(got, ref.encode(c, sample, order, 12))


def test_a_childs_code_shifted_is_its_parents():
    values = ref.small(ref.DEFAULTS)
    plan = plans(2, values)[0]
    sl = plan.serial.levels
    for l in range(1, LEVELS):
        fine = plan.levels[l - 1].valid
        parent = plan.levels[l].f2c[fine]
        for o in range(len(ser.ORDERS)):
            assert torch.equal(sl[l - 1].codes[o][fine] >> 3,
                               sl[l].codes[o][parent]), (l, o)
    ref_codes = ref.level_codes(plans(2, values)[1], ser.ORDERS)
    for l in range(LEVELS):
        assert torch.equal(valid_rows(plan, l, sl[l].codes.T).T,
                           ref_codes[l]), l


# -- patches -----------------------------------------------------------------

def pointcept_padding(counts: list, k: int) -> tuple:
    """Pointcept's ``SerializedAttention.get_padding_and_inverse`` (its
    flash path): ``pad`` (padded place -> place in the sorted points),
    ``unpad`` and ``cu_seqlens``."""
    bincount = torch.tensor(counts)
    offset = torch.cumsum(bincount, dim=0)
    bincount_pad = torch.div(bincount + k - 1, k, rounding_mode="trunc") * k
    mask_pad = bincount > k
    bincount_pad = ~mask_pad * bincount + mask_pad * bincount_pad
    _offset = F.pad(offset, (1, 0))
    _offset_pad = F.pad(torch.cumsum(bincount_pad, dim=0), (1, 0))
    pad = torch.arange(_offset_pad[-1])
    unpad = torch.arange(_offset[-1])
    cu_seqlens = []
    for i in range(len(offset)):
        unpad[_offset[i]:_offset[i + 1]] += _offset_pad[i] - _offset[i]
        if bincount[i] != bincount_pad[i]:
            end, tail = _offset_pad[i + 1], bincount[i] % k
            pad[end - k + tail:end] = pad[end - 2 * k + tail:end - k]
        pad[_offset_pad[i]:_offset_pad[i + 1]] -= _offset_pad[i] - _offset[i]
        cu_seqlens.append(torch.arange(_offset_pad[i], _offset_pad[i + 1],
                                       step=k))
    cu_seqlens = F.pad(torch.cat(cu_seqlens), (0, 1), value=_offset_pad[-1])
    return pad, unpad, cu_seqlens


def test_patch_layout_is_pointcepts_padding():
    k, counts, cap = 1024, [2500, 2048, 700], 2600
    s = len(counts)
    g = torch.Generator().manual_seed(3)
    valid = torch.arange(cap)[None] < torch.tensor(counts)[:, None]
    codes = torch.randperm(s * cap, generator=g).reshape(s, cap) \
        + (torch.arange(s)[:, None] << 40)
    codes = torch.where(valid, codes, torch.iinfo(torch.int64).max)
    idx, bias, inverse = ser.patch_layout(codes.reshape(-1),
                                          valid.reshape(-1), s, k)
    pad, unpad, cu = pointcept_padding(counts, k)
    width = -(-cap // k) * k
    sorted_rows = torch.argsort(codes, dim=1)
    starts = F.pad(torch.cumsum(torch.tensor(counts), dim=0), (1, 0))
    at = 0
    for i, n in enumerate(counts):
        n_pad = n if n <= k else -(-n // k) * k
        mine = idx[i * width:i * width + n_pad] - i * cap
        want = sorted_rows[i][pad[at:at + n_pad] - starts[i]]
        assert torch.equal(mine, want), n
        assert torch.equal(bias[i * width:(i + 1) * width] == 0,
                           torch.arange(width) < n_pad), n
        assert torch.equal(unpad[starts[i]:starts[i + 1]] - at,
                           torch.arange(n))
        rows = sorted_rows[i][:n] + i * cap
        assert torch.equal(inverse[rows] - i * width, torch.arange(n))
        # the sequences: whole patches of the sample's layout, or one of n
        seqs = cu[(cu >= at) & (cu < at + n_pad)] - at
        assert seqs.tolist() == list(range(0, n_pad, k)), n
        at += n_pad
    # the reference's layout of the same codes
    keep = valid.reshape(-1)
    sample = torch.arange(s).repeat_interleave(cap)[keep]
    lay = ref.Layout(codes.reshape(-1)[keep], sample, k)
    assert lay.full.shape[0] == 3 + 2 and len(lay.short) == 1
    assert torch.equal(lay.rank, inverse[keep.nonzero()[:, 0]]
                       - sample * width)


# -- the plan ----------------------------------------------------------------

def test_plan_coordinates_and_stem_map_are_the_references():
    values = ref.small(ref.DEFAULTS)
    plan, mine, _ = plans(4, values)
    for l in range(LEVELS):
        sl = plan.serial.levels[l]
        assert torch.equal(valid_rows(plan, l, sl.coords),
                           mine.levels[l].coords)
        assert torch.equal(valid_rows(plan, l, sl.key), mine.levels[l].key)
    # slot -> voxel at level 0, then the 5x5x5 maps against each other
    valid = plan.levels[0].valid
    voxel = torch.full((valid.shape[0],), -1, dtype=torch.long)
    voxel[valid] = torch.arange(int(valid.sum()))
    nbr = plan.serial.stem_nbr[valid]
    got = torch.where(nbr >= 0, voxel[nbr.clamp(min=0)], -1)
    want = sp.neighbours(mine.levels[0], 5)
    assert torch.equal(got, want)
    assert int((want >= 0).sum()) > int((mine.levels[0].nbr >= 0).sum())


# -- the net -----------------------------------------------------------------

def _nets(values: dict) -> tuple:
    """(port, reference) backbones with one dict of seeded weights."""
    mine = ref.build(values, torch.float32)
    params = weights.seeded_params(mine, 7, "cpu")
    port = ptv3.PointTransformerV3(**values, compute_dtype=torch.float32)
    for net in (mine, port):
        own = dict(net.named_parameters())
        assert set(own) == set(params)
        with torch.no_grad():
            for k, t in params.items():
                own[k].copy_(t)
    return port, mine


def _run(net, plan, feats, w, training: bool) -> tuple:
    net.train(training)
    net.zero_grad()
    out = net(feats, plan, 2, torch.Generator().manual_seed(5))
    (out * w).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in
                          net.named_parameters()}


def _bf16_attention(sdpa):
    def run(q, k, v, scale):
        return sdpa(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale).float()
    return run


@pytest.mark.parametrize("attention", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_and_gradients_match_the_reference(mode, attention,
                                                   monkeypatch):
    values = ref.small(ref.DEFAULTS)
    plan, mine, feats = plans(6, values)
    port, ref_net = _nets(values)
    if attention == "bfloat16":
        monkeypatch.setattr(ptv3, "_sdpa", _bf16_attention(ptv3._sdpa))
    w = torch.randn(SCANS * POINTS, values["dec_channels"][0],
                    generator=torch.Generator().manual_seed(9))
    training = mode == "train"
    got, got_g = _run(port, plan, feats, w, training)
    want, want_g = _run(ref_net, mine, feats, w, training)
    out_gap = float((got - want).norm() / want.norm())
    med = statistics.median(float(g.norm()) for g in want_g.values())
    grad_gap = max(float((got_g[k] - g).norm()) / max(float(g.norm()), med)
                   for k, g in want_g.items())
    if attention == "float32":
        assert out_gap < OUT_TOL and grad_gap < GRAD_TOL, (out_gap,
                                                           grad_gap)
    else:
        assert out_gap > OUT_TOL and grad_gap > GRAD_TOL, (out_gap,
                                                           grad_gap)
    # the drop path and the shuffle act in training alone
    assert port.drops and ref_net.drops


def test_train_runs_ptv3_and_validates(tmp_path):
    from mopa_tpu_torch.config.xmuda import cfg as base
    from mopa_tpu_torch.train import common

    c = base.clone()
    c.merge_from_file("configs/synthetic/mopa_smoke.yaml")
    c.MODEL_3D.TYPE = "PTv3"
    for k, v in ref.small({}).items():
        c.MODEL_3D.PTv3[k] = tuple(v)
    c.TRAIN.PC_MM.lambda_pc_mm = 0.0
    c.TRAIN.PC_MM.lambda_sam_cons = 0.0
    c.TRAIN.PC_MM.ema_start_iter = 100
    t = c.DATASET_TARGET.SyntheticSCN
    t.with_vgi = t.with_ema = t.with_sam_mask = False
    c.SCHEDULER.MAX_ITERATION = 2
    c.VAL.PERIOD = 2
    c.TRAIN.CHECKPOINT_PERIOD = 2
    c.freeze()
    ptv3.ATTN.update(launches=0, tokens=0)
    state, evals = common.train(c, logging.getLogger("ptv3-test"),
                                str(tmp_path), "run", "xmuda", device="cpu")
    assert state.step == 2
    assert set(evals) >= {"2D", "3D", "2D+3D"}
    # two train steps and the validation's forwards ran the attention, one
    # call a block (8 blocks at the small depths)
    assert ptv3.ATTN["launches"] > 2 * 8
    assert (tmp_path / "model_3d_000002.pth").is_file()


# -- on the card --------------------------------------------------------------

@pytest.mark.card
def test_patch_attention_on_the_card_matches_the_textbook():
    """Level 3 of the published widths (256 channels, 16 heads of 16, K =
    1024) over scans of 2500, 2048, 700 and 3000 voxels: the flash kernels
    (a kernel name holding ``ptv3.KERNEL_FRAGMENT``, forward and backward;
    no math fallback) against the reference's float32 textbook attention
    on the same bfloat16 inputs, within bfloat16's rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    c, h, k, cap = 256, 16, 1024, 3072
    counts = [2500, 2048, 700, 3000]
    s = len(counts)
    g = torch.Generator(device=dev).manual_seed(0)
    valid = torch.arange(cap, device=dev)[None] \
        < torch.tensor(counts, device=dev)[:, None]
    codes = torch.randperm(s * cap, device=dev, generator=g).reshape(s, cap) \
        + (torch.arange(s, device=dev)[:, None] << 40)
    codes = torch.where(valid, codes, torch.iinfo(torch.int64).max).reshape(-1)
    idx, bias, inverse = ser.patch_layout(codes, valid.reshape(-1), s, k)
    layout = ptv3.Layout(idx, bias, inverse, torch.zeros((), device=dev),
                         codes, k)
    qkv = torch.randn((s * cap, 3 * c), device=dev, generator=g).bfloat16()
    q = qkv.clone().requires_grad_()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ptv3.patch_attention(q, layout, h)
        got.float().square().sum().backward()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA"}
    attn = [n for n in names if ptv3.KERNEL_FRAGMENT in n]
    assert len(attn) >= 2, sorted(names)
    keep = valid.reshape(-1)
    sample = torch.arange(s * cap, device=dev) // cap
    with torch.no_grad():
        want = ref.attend(qkv.float()[keep],
                          ref.Layout(codes[keep], sample[keep], k), h)
    err = float((got.float()[keep] - want).abs().max() / want.abs().max())
    assert err < 2e-2, err
    assert torch.isfinite(q.grad).all()
