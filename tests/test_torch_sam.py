"""The port's Segment-Anything (``mopa_tpu_torch.models.sam``), its
multi-head attention blocks and ``data.sam_refine`` against the JAX package's,
in float32 on the CPU.

The tiny variant of ``tests/test_sam.py`` (depth 2, dim 64, 4 heads, global
block 1) is registered in both ``VARIANTS``. flax's variables are initialised
(jitted), every leaf is redrawn from a seed so that no parameter is zero or
one (``pos_embed`` and the relative positions start at zero in flax), and they
cross to the port through ``models.weights``. Modules agree within 1e-5 of
max|ref|, whole SAM forwards within 1e-4, id maps exactly.
"""

import functools
import os
import os.path as osp
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mopa_tpu.data import sam_refine as jax_refine
from mopa_tpu.models import attention as jax_attn
from mopa_tpu.models import sam as jax_sam
from mopa_tpu.models.torch_compat import flatten_pytree, unflatten_into
from mopa_tpu_torch.data import sam_refine as port_refine
from mopa_tpu_torch.models import attention as port_attn
from mopa_tpu_torch.models import sam as port_sam
from mopa_tpu_torch.models import weights
from test_datasets_real_format import make_fake_kitti

torch.set_num_threads(1)

TINY = dict(depth=2, dim=64, heads=4, global_idx=(1,))
MODULE_TOL = 1e-5  # of max|ref|
SAM_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_variant():
    for variants in (jax_sam.VARIANTS, port_sam.VARIANTS):
        variants["vit_t"] = dict(TINY)
    yield


def redraw(flat, seed):
    """Every flax leaf redrawn from ``seed``: kernels normal with variance
    1 / fan_in, norm scales near one, biases and raw parameters normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(flat.items()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            a = rng.normal(0, np.prod(v.shape[:-1]) ** -0.5, v.shape)
        elif leaf == "scale":
            a = 1 + 0.1 * rng.normal(size=v.shape)
        elif leaf == "bias":
            a = 0.1 * rng.normal(size=v.shape)
        elif leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            a = 0.5 * rng.normal(size=v.shape)
        else:
            a = rng.normal(size=v.shape)
        out[name] = a.astype(np.float32)
    return out


def flax_params(module, *args, seed=0):
    """(flat redrawn params, flax variables) of ``module`` initialised on
    ``args``."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), *args)
    flat = redraw(flatten_pytree(variables["params"]), seed)
    return flat, {"params": unflatten_into(variables["params"], flat)}


def port_module(module, flat):
    weights.load_flax_state(module, flat, {})
    return module.eval()


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def assert_close(got, ref, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------------------------ modules


def test_layer_norm_eps():
    """flax's default eps (1e-6), not torch's 1e-5: visible on inputs of
    small variance."""
    from flax import linen as fnn

    x = 1e-3 * np.random.default_rng(0).normal(size=(3, 64)).astype(
        np.float32)
    mod = fnn.LayerNorm()
    flat, variables = flax_params(mod, x)
    ref = jax.jit(mod.apply)(variables, x)
    port = port_module(port_sam.LayerNorm(64), flat)
    with torch.no_grad():
        assert_close(port(t(x)), ref, MODULE_TOL)


@pytest.mark.parametrize("window,hw", [(3, (5, 7)), (14, (4, 4)),
                                       (0, (5, 7))],
                         ids=["windowed", "window_padded", "global"])
def test_window_attention(window, hw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2,) + hw + (64,)).astype(np.float32)
    mod = jax_sam.WindowAttention(64, 4, window)
    flat, variables = flax_params(mod, x)
    ref = jax.jit(mod.apply)(variables, x)
    port = port_module(port_sam.WindowAttention(64, 4, window, max(hw)),
                       flat)
    with torch.no_grad():
        assert_close(port(t(x)), ref, MODULE_TOL)


def test_window_attention_refuses_other_grid():
    port = port_sam.WindowAttention(64, 4, 0, grid=5)
    with pytest.raises(ValueError, match="relative"):
        port(torch.zeros(1, 4, 4, 64))


def test_vit_block():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 7, 64)).astype(np.float32)
    mod = jax_sam.ViTBlock(64, 4, 3)
    flat, variables = flax_params(mod, x)
    ref = jax.jit(mod.apply)(variables, x)
    port = port_module(port_sam.ViTBlock(64, 4, 3), flat)
    with torch.no_grad():
        assert_close(port(t(x)), ref, MODULE_TOL)


def test_dense_positional_encoding():
    g = np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32)
    ref = jax_sam.dense_positional_encoding(jnp.asarray(g), (5, 7))
    assert_close(port_sam.dense_positional_encoding(t(g), (5, 7)), ref,
                 MODULE_TOL)


@pytest.mark.parametrize("rate", [1, 2])
def test_decoder_attention(rate):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 64)).astype(np.float32)
    k = rng.normal(size=(2, 9, 64)).astype(np.float32)
    v = rng.normal(size=(2, 9, 64)).astype(np.float32)
    mod = jax_sam.DecoderAttention(64, 4, rate)
    flat, variables = flax_params(mod, q, k, v)
    ref = jax.jit(mod.apply)(variables, q, k, v)
    port = port_module(port_sam.DecoderAttention(64, 4, rate), flat)
    with torch.no_grad():
        assert_close(port(t(q), t(k), t(v)), ref, MODULE_TOL)


@pytest.mark.parametrize("skip", [True, False], ids=["skip_pe", "with_pe"])
def test_two_way_block(skip):
    rng = np.random.default_rng(5)
    args = [rng.normal(size=s).astype(np.float32)
            for s in ((2, 5, 64), (2, 12, 64), (2, 5, 64), (2, 12, 64))]
    mod = jax_sam.TwoWayBlock(64, 4, 128, skip)
    flat, variables = flax_params(mod, *args)
    assert "mlp.lin1.kernel" in flat
    ref_q, ref_k = jax.jit(mod.apply)(variables, *args)
    port = port_module(port_sam.TwoWayBlock(64, 4, 128, skip), flat)
    with torch.no_grad():
        q, k = port(*map(t, args))
    assert_close(q, ref_q, MODULE_TOL)
    assert_close(k, ref_k, MODULE_TOL)


def test_mask_decoder():
    rng = np.random.default_rng(6)
    embed = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    pe = rng.normal(size=(1, 4, 4, 64)).astype(np.float32)
    sparse = rng.normal(size=(2, 3, 64)).astype(np.float32)
    dense = rng.normal(size=(64,)).astype(np.float32)
    mod = jax_sam.MaskDecoder(dim=64, mlp_dim=128)
    flat, variables = flax_params(mod, embed, pe, sparse, dense)
    ref_m, ref_iou = jax.jit(mod.apply)(variables, embed, pe, sparse, dense)
    port = port_module(port_sam.MaskDecoder(dim=64, mlp_dim=128), flat)
    with torch.no_grad():
        masks, iou = port(t(embed), t(pe), t(sparse), t(dense))
    assert masks.shape == (2, 4, 16, 16)
    assert_close(masks, ref_m, MODULE_TOL)
    assert_close(iou, ref_iou, MODULE_TOL)


def test_multi_head_attention():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 5, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 7, 16)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 5, 7)) > 0.4
    mask[..., 0] = True
    mod = jax_attn.MultiHeadAttention(n_head=2, d_model=16, d_k=8, d_v=8)
    flat, variables = flax_params(mod, q, kv, kv)
    port = port_module(port_attn.MultiHeadAttention(2, 16, 8, 8), flat)
    for m in (None, mask):
        ref_out, ref_attn = jax.jit(mod.apply)(variables, q, kv, kv, mask=m)
        with torch.no_grad():
            out, attn = port(t(q), t(kv), t(kv),
                             mask=None if m is None else torch.from_numpy(m))
        assert_close(out, ref_out, MODULE_TOL)
        assert_close(attn, ref_attn, MODULE_TOL)


# --------------------------------------------------------------- whole SAM

CASES = {
    # (img_size, image side, port grid): the 4 x 4 grid padded to 14 x 14
    # windows; exact 14 x 14 windows; "SAME" padding 72 -> 80 with
    # pos_embed grown 4 -> 5; pos_embed shrunk 4 -> 3 with antialiasing
    "padded": (64, 64, None),
    "exact": (224, 224, None),
    "same_pad_grown": (72, 72, None),
    "shrunk": (64, 48, 3),
}


@functools.lru_cache(maxsize=None)
def sam_case(name):
    img_size, side, grid = CASES[name]
    rng = np.random.default_rng(8)
    img = rng.normal(size=(2, side, side, 3)).astype(np.float32)
    pts = rng.uniform(0, img_size, (2, 3, 2)).astype(np.float32)
    lab = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    model = jax_sam.SAM(variant="vit_t", img_size=img_size)
    flat, variables = flax_params(model, img, pts, lab, seed=9)
    port = port_module(port_sam.SAM("vit_t", img_size, device="cpu",
                                    grid=grid), flat)
    return dict(model=model, flat=flat, variables=variables, port=port,
                img=img, pts=pts, lab=lab, apply=jax.jit(model.apply))


@pytest.mark.parametrize("name", list(CASES))
def test_sam_forward(name):
    c = sam_case(name)
    ref_m, ref_iou = c["apply"](c["variables"], c["img"], c["pts"], c["lab"])
    with torch.no_grad():
        masks, iou = c["port"](t(c["img"]), t(c["pts"]), t(c["lab"]))
    assert np.abs(np.asarray(ref_m)).max() > 0
    assert_close(masks, ref_m, SAM_TOL)
    assert_close(iou, ref_iou, SAM_TOL)


def test_image_encoder():
    c = sam_case("same_pad_grown")
    ref = jax.jit(functools.partial(c["model"].apply,
                                    method=jax_sam.SAM.encode))(
        c["variables"], c["img"])
    with torch.no_grad():
        assert_close(c["port"].encode(t(c["img"])), ref, MODULE_TOL)


def test_prompt_encoder():
    c = sam_case("padded")
    pts = np.random.default_rng(10).uniform(0, 64, (2, 3, 2)).astype(
        np.float32)
    lab = np.array([[-1, 0, 1], [1, -1, 0]], np.float32)
    ref = jax.jit(functools.partial(
        c["model"].apply,
        method=lambda m, p, l: m.prompt_encoder(p, l, (64, 64))[0]))(
        c["variables"], pts, lab)
    with torch.no_grad():
        sparse, _, _ = c["port"].prompt_encoder(t(pts), t(lab), (64, 64))
    assert_close(sparse, ref, MODULE_TOL)


def test_bridge_round_trip():
    c = sam_case("padded")
    port = c["port"]
    back = weights.to_flax(port, weights.from_flax(port, c["flat"],
                                                   port.state_dict()))
    assert sorted(back) == sorted(c["flat"])
    for name, v in c["flat"].items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)
    assert "mask_decoder.hyper_mlps.3.layers.2.kernel" in back
    assert "mask_decoder.layers.1.mlp.lin2.kernel" in back
    assert "image_encoder.block1.attn.rel_pos_h" in back
    extra = dict(c["flat"], **{"mask_decoder.extra.kernel": np.zeros(1)})
    with pytest.raises(KeyError):
        weights.from_flax(port, extra, port.state_dict())
    short = dict(c["flat"])
    del short["mask_decoder.up_ln.scale"]
    with pytest.raises(KeyError):
        weights.from_flax(port, short, port.state_dict())


def test_port_sam_seeded_weights():
    a = port_sam.SAM("vit_t", 64, device="cpu", seed=3).state_dict()
    b = port_sam.SAM("vit_t", 64, device="cpu", seed=3).state_dict()
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
    assert a["image_encoder.block0.norm1.scale"].eq(1).all()
    assert a["image_encoder.pos_embed"].abs().max() > 0


# ------------------------------------------------ segment-anything checkpoint


def segment_anything_state(variant, img_size, seed):
    """A seeded state dict with segment-anything's names and torch layouts
    (``sam_model_registry``'s modules), box and mask prompt parts
    included."""
    cfgv = jax_sam.VARIANTS[variant]
    dim, hd = cfgv["dim"], cfgv["dim"] // cfgv["heads"]
    g = img_size // 16
    shapes = {}

    def lin(name, o, i, bias=True):
        shapes[name + ".weight"] = (o, i)
        if bias:
            shapes[name + ".bias"] = (o,)

    def norm(name, c):
        shapes[name + ".weight"] = (c,)
        shapes[name + ".bias"] = (c,)

    enc = "image_encoder"
    shapes[enc + ".patch_embed.proj.weight"] = (dim, 3, 16, 16)
    shapes[enc + ".patch_embed.proj.bias"] = (dim,)
    shapes[enc + ".pos_embed"] = (1, g, g, dim)
    for i in range(cfgv["depth"]):
        s = "{}.blocks.{}".format(enc, i)
        size = g if i in cfgv["global_idx"] else 14
        norm(s + ".norm1", dim)
        norm(s + ".norm2", dim)
        lin(s + ".attn.qkv", 3 * dim, dim)
        lin(s + ".attn.proj", dim, dim)
        shapes[s + ".attn.rel_pos_h"] = (2 * size - 1, hd)
        shapes[s + ".attn.rel_pos_w"] = (2 * size - 1, hd)
        lin(s + ".mlp.lin1", 4 * dim, dim)
        lin(s + ".mlp.lin2", dim, 4 * dim)
    shapes[enc + ".neck.0.weight"] = (256, dim, 1, 1)
    norm(enc + ".neck.1", 256)
    shapes[enc + ".neck.2.weight"] = (256, 256, 3, 3)
    norm(enc + ".neck.3", 256)

    pe = "prompt_encoder"
    shapes[pe + ".pe_layer.positional_encoding_gaussian_matrix"] = (2, 128)
    for i in range(4):
        shapes["{}.point_embeddings.{}.weight".format(pe, i)] = (1, 256)
    shapes[pe + ".not_a_point_embed.weight"] = (1, 256)
    shapes[pe + ".no_mask_embed.weight"] = (1, 256)
    shapes[pe + ".mask_downscaling.0.weight"] = (4, 1, 2, 2)
    shapes[pe + ".mask_downscaling.0.bias"] = (4,)

    md = "mask_decoder"
    shapes[md + ".iou_token.weight"] = (1, 256)
    shapes[md + ".mask_tokens.weight"] = (4, 256)

    def attn(name, rate):
        for p in ("q_proj", "k_proj", "v_proj"):
            lin("{}.{}".format(name, p), 256 // rate, 256)
        lin(name + ".out_proj", 256, 256 // rate)

    tr = md + ".transformer"
    for i in range(2):
        s = "{}.layers.{}".format(tr, i)
        attn(s + ".self_attn", 1)
        attn(s + ".cross_attn_token_to_image", 2)
        attn(s + ".cross_attn_image_to_token", 2)
        lin(s + ".mlp.lin1", 2048, 256)
        lin(s + ".mlp.lin2", 256, 2048)
        for n in range(1, 5):
            norm("{}.norm{}".format(s, n), 256)
    attn(tr + ".final_attn_token_to_image", 2)
    norm(tr + ".norm_final_attn", 256)
    shapes[md + ".output_upscaling.0.weight"] = (256, 64, 2, 2)
    shapes[md + ".output_upscaling.0.bias"] = (64,)
    norm(md + ".output_upscaling.1", 64)
    shapes[md + ".output_upscaling.3.weight"] = (64, 32, 2, 2)
    shapes[md + ".output_upscaling.3.bias"] = (32,)
    for i in range(4):
        for j, (o, n_in) in enumerate(((256, 256), (256, 256), (32, 256))):
            lin("{}.output_hypernetworks_mlps.{}.layers.{}".format(md, i, j),
                o, n_in)
    for j, (o, n_in) in enumerate(((256, 256), (256, 256), (4, 256))):
        lin("{}.iou_prediction_head.layers.{}".format(md, j), o, n_in)

    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * (np.prod(s[1:]) ** -0.5 if len(s) > 1
                                      else 0.3)).astype(np.float32)
            for k, s in shapes.items()}


def test_import_sam_checkpoint():
    c = sam_case("padded")
    sd = segment_anything_state("vit_t", 64, seed=11)
    jax_flat = jax_sam.import_sam_checkpoint(sd, variant="vit_t")
    port_flat = port_sam.import_sam_checkpoint(sd, variant="vit_t")
    port = port_sam.SAM("vit_t", 64, device="cpu")
    port.load_state_dict(port_flat, strict=True)
    # the JAX importer through the bridge gives the same tensors
    bridged = weights.from_flax(port, jax_flat, port.state_dict())
    assert sorted(bridged) == sorted(port_flat)
    for name, v in port_flat.items():
        torch.testing.assert_close(bridged[name], v, rtol=0, atol=0,
                                   msg=name)
    variables = {"params": unflatten_into(c["variables"]["params"],
                                          jax_flat)}
    ref_m, ref_iou = c["apply"](variables, c["img"], c["pts"], c["lab"])
    with torch.no_grad():
        masks, iou = port.eval()(t(c["img"]), t(c["pts"]), t(c["lab"]))
    assert_close(masks, ref_m, SAM_TOL)
    assert_close(iou, ref_iou, SAM_TOL)
    # a port name left unfilled, or a checkpoint name missing, raises
    short = dict(port_flat)
    del short["mask_decoder.up2.weight"]
    with pytest.raises(RuntimeError, match="up2.weight"):
        port.load_state_dict(short, strict=True)
    del sd["mask_decoder.output_upscaling.3.weight"]
    for importer in (jax_sam.import_sam_checkpoint,
                     port_sam.import_sam_checkpoint):
        with pytest.raises(KeyError):
            importer(sd, variant="vit_t")


# --------------------------------------------------------- id map generator


def test_generate_mask_id_map():
    c = sam_case("padded")
    image = c["img"][0]
    _, scores = port_sam.grid_masks(c["port"], t(image), 4, 64)
    drop = float(np.median(scores.numpy()))
    assert 0 < int((scores > drop).sum()) < 16
    jax_gen = jax.jit(lambda v, im, thresh: jax_sam.generate_mask_id_map(
        c["model"].apply, v, im, points_per_side=4, mask_budget=8,
        iou_thresh=thresh, img_size=64))
    maps = []
    for thresh in (-1e9, drop):
        ref = np.asarray(jax_gen(c["variables"], image, thresh))
        got = port_sam.generate_mask_id_map(
            c["port"], t(image), points_per_side=4, mask_budget=8,
            iou_thresh=thresh, img_size=64)
        assert got.dtype == torch.int32 and got.shape == (64, 64)
        np.testing.assert_array_equal(got.numpy(), ref)
        maps.append(ref)
    assert len(np.unique(maps[0])) > 2
    assert not np.array_equal(maps[0], maps[1])


SQUARE_CELLS = 16  # the fake decoder's mask grid (4x upscaled to 64)


def square_masks_jax(pts):
    """The fake decoder, JAX side: per prompt (x, y) four mask logits on a
    16 x 16 grid, +1 inside a square around the prompt's cell (radius 2 for
    masks 0-1, 1 for masks 2-3), -1 outside; IoU scores [0.2, s, 0.1, 0.3]
    with s = (x + y) / 128. Many masks tie in area."""
    cell = jnp.floor(pts / 4)  # (B, 2) x, y
    i = jnp.arange(SQUARE_CELLS)[None, :, None]
    j = jnp.arange(SQUARE_CELLS)[None, None, :]
    masks = []
    for r in (2, 2, 1, 1):
        inside = (jnp.abs(i - cell[:, 1, None, None]) <= r) \
            & (jnp.abs(j - cell[:, 0, None, None]) <= r)
        masks.append(jnp.where(inside, 1.0, -1.0))
    s = pts.sum(-1) / 128
    iou = jnp.stack([jnp.full_like(s, 0.2), s, jnp.full_like(s, 0.1),
                     jnp.full_like(s, 0.3)], -1)
    return jnp.stack(masks, 1), iou


class SquareSAM(torch.nn.Module):
    """The fake decoder, port side (``SAM.encode`` / ``decode``)."""

    img_size = 64

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def encode(self, image):
        return torch.zeros(image.shape[0], 4, 4, 8)

    def decode(self, emb, points, labels):
        pts = points[:, 0]
        cell = torch.floor(pts / 4)
        i = torch.arange(SQUARE_CELLS)[None, :, None]
        j = torch.arange(SQUARE_CELLS)[None, None, :]
        masks = []
        for r in (2, 2, 1, 1):
            inside = ((i - cell[:, 1, None, None]).abs() <= r) \
                & ((j - cell[:, 0, None, None]).abs() <= r)
            masks.append(torch.where(inside, 1.0, -1.0))
        s = pts.sum(-1) / 128
        iou = torch.stack([torch.full_like(s, 0.2), s,
                           torch.full_like(s, 0.1),
                           torch.full_like(s, 0.3)], -1)
        return torch.stack(masks, 1), iou


def test_mask_id_map_prompt_order_and_ties():
    """Area ties broken by prompt order: the x-major grid, a stable sort,
    smaller masks written last, the IoU cut and the budget."""

    def apply_fn(variables, *args, method=None):
        if method is jax_sam.SAM.encode:
            return jnp.zeros((1, 4, 4, 8))
        return square_masks_jax(args[1][:, 0])

    image = np.zeros((64, 64, 3), np.float32)
    for thresh, budget in ((-1e9, 16), (0.5, 16), (-1e9, 5)):
        ref = np.asarray(jax_sam.generate_mask_id_map(
            apply_fn, {}, jnp.asarray(image), points_per_side=4,
            mask_budget=budget, iou_thresh=thresh, img_size=64))
        got = port_sam.generate_mask_id_map(
            SquareSAM(), t(image), points_per_side=4, mask_budget=budget,
            iou_thresh=thresh, img_size=64)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert len(np.unique(ref)) > 3


# ------------------------------------------------------------- sam_refine


def fake_generator(image):
    """Deterministic masks from thresholds on the image, two of equal
    area."""
    masks = []
    for ch, thr in ((0, 64), (1, 128), (2, 192), (0, 200)):
        seg = image[..., ch] > thr
        masks.append({"segmentation": seg, "area": int(seg.sum())})
    half = np.zeros(image.shape[:2], bool)
    half[: image.shape[0] // 2] = True
    masks.append({"segmentation": half, "area": int(half.sum())})
    masks.append({"segmentation": ~half, "area": int(half.sum())})
    return masks


def files_under(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(osp.join(d, n), "rb") as f:
                out[osp.relpath(osp.join(d, n), root)] = f.read()
    return out


def test_rasterize_masks():
    image = np.random.default_rng(12).integers(0, 255, (30, 40, 3),
                                               np.uint8)
    masks = fake_generator(image)
    np.testing.assert_array_equal(
        port_refine.rasterize_masks(masks, (30, 40)),
        jax_refine.rasterize_masks(masks, (30, 40)))


def make_fake_nuscenes(root):
    rng = np.random.default_rng(13)
    data = []
    for cam in ("CAM_FRONT", "CAM_BACK"):
        os.makedirs(osp.join(root, "samples", cam))
        path = "samples/{}/frame_{}.jpg".format(cam, cam.lower())
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), np.uint8)).save(
            osp.join(root, path))
        data.append({"camera_path": path})
    pkl = osp.join(root, "train_all.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    return pkl


def test_mask_generators(tmp_path):
    root = str(tmp_path)
    make_fake_kitti(root, with_extras=False)
    pkl = make_fake_nuscenes(root)
    for pkg, name in ((jax_refine, "jax"), (port_refine, "port")):
        pkg.kitti_mask_generator(fake_generator, root, ["00", "07"],
                                 mask_dir="mask_" + name)
        pkg.nuscenes_mask_generator(fake_generator, root, pkl, "train",
                                    mask_dir="mask_" + name)
    jax_files = files_under(osp.join(root, "mask_jax"))
    assert len(jax_files) == 6  # 2 scenes x 2 frames + 2 cameras
    assert files_under(osp.join(root, "mask_port")) == jax_files


def stub_segment_anything(devices):
    """A ``segment_anything`` module whose generator is
    :func:`fake_generator`; ``devices`` records each ``sam.to``."""
    mod = types.ModuleType("segment_anything")

    class Sam:
        def to(self, device):
            devices.append(device)
            return self

    class SamAutomaticMaskGenerator:
        def __init__(self, sam):
            self.sam = sam

        def generate(self, image):
            return fake_generator(image)

    mod.sam_model_registry = {"vit_h": lambda checkpoint: Sam()}
    mod.SamAutomaticMaskGenerator = SamAutomaticMaskGenerator
    return mod


@pytest.mark.parametrize("dataset", ["kitti", "nuscenes"])
def test_main_with_stub(dataset, tmp_path, monkeypatch):
    devices = []
    monkeypatch.setitem(sys.modules, "segment_anything",
                        stub_segment_anything(devices))
    out = {}
    for pkg, name in ((jax_refine, "jax"), (port_refine, "port")):
        root = str(tmp_path / name)
        if dataset == "kitti":
            make_fake_kitti(root, with_extras=False)
            extra = ["--scenes", "00", "07"]
        else:
            os.makedirs(root)
            extra = ["--pkl", make_fake_nuscenes(root), "--split", "train"]
        monkeypatch.setattr(sys, "argv", [
            "sam_refine", "--dataset", dataset, "--root_dir", root,
            "--checkpoint", "sam_vit_h.pth"] + extra)
        pkg.main()
        out[name] = files_under(osp.join(root, "img_mask"))
    assert out["jax"] and out["port"] == out["jax"]
    assert devices == ["cpu", "cuda"]


def test_make_sam_generator_needs_segment_anything(monkeypatch):
    monkeypatch.setitem(sys.modules, "segment_anything", None)
    with pytest.raises(ImportError):
        jax_refine.make_sam_generator("sam_vit_h.pth")
    with pytest.raises(ImportError, match="segment_anything"):
        port_refine.make_sam_generator("sam_vit_h.pth")
