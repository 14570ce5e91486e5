"""The submanifold conv's backward (K2) in the port against the JAX reference.

The plain twin of K2 (``submanifold_conv_wide_bwd_ref``) and the port's
autograd Function are held to ``jax.vjp`` of
``mopa_tpu.ops.sparse_conv.submanifold_conv_wide`` at every (Cin, Cout)
pattern of a small SparseUNet (m=4, 3 planes; Cin=1 and Cin > Cout
included) plus one width that takes the reference's chunked-gather branch,
and to the Pallas K2 in interpret mode on a localised plan. Plans come from
the port's builder on three scans. Padding rows of the features and of the
cotangent are NOT zero (batch norm writes its bias there): the plan's dz
codes alone must keep them out, as in the reference. float32, to 1e-5 of
the largest |value| (a d_w entry sums thousands of products of size ~20, so
the summation order alone moves it by ~1e-5 in absolute terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu.ops import sparse_conv_pallas as scp
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.ops import sparse_conv as psc

torch.set_num_threads(1)

S, P, LEVELS = 3, 300, 3


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def plan():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 12, size=(S, P, 3)).astype(np.int32)
    valid = np.ones((S, P), bool)
    valid[1, int(P * 0.7):] = False
    caps = jax_unet.capacity_schedule(P, LEVELS)
    return port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), LEVELS,
        capacities=caps), caps


def _inputs(seed, v, cin, cout):
    """feats, weight and cotangent, non-zero on padding rows too."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    return feats, w, g


def _jax_vjp(conv, feats, w, g):
    _, vjp = jax.vjp(conv, jnp.asarray(feats), jnp.asarray(w))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


# (level, Cin, Cout): the stem, l0/l1/l2 conv1 and conv2 of m=4, 3 planes,
# and a width past the reference's chunked-gather threshold (3*Cout > 127)
SHAPES = [(0, 1, 4), (0, 4, 4), (0, 8, 4), (1, 8, 8), (1, 16, 8),
          (2, 12, 12), (2, 64, 48)]


@pytest.mark.parametrize("level,cin,cout", SHAPES)
def test_k2_twin_and_function_match_jax_vjp(plan, level, cin, cout):
    lv = plan[0].levels[level]
    v = lv.valid.shape[0]
    feats, w, g = _inputs(level * 1000 + cin * 10 + cout, v, cin, cout)
    assert not np.all(feats[~lv.valid.numpy()] == 0)
    wide = jsc.WidePlan(jnp.asarray(lv.ranks.numpy()),
                        jnp.asarray(lv.sel.numpy()))
    df_want, dw_want = _jax_vjp(
        lambda f, w_: jsc.submanifold_conv_wide(f, wide, w_), feats, w, g)

    df, dw = psc.submanifold_conv_wide_bwd_ref(
        torch.from_numpy(g), torch.from_numpy(feats), lv.ranks, lv.sel,
        torch.from_numpy(w))
    assert df.dtype == torch.float32 and dw.dtype == torch.float32
    _close(df.numpy(), df_want)
    _close(dw.numpy(), dw_want)

    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out = psc.submanifold_conv_wide(f_t, psc.WidePlan(lv.ranks, lv.sel), w_t)
    out.backward(torch.from_numpy(g))
    _close(f_t.grad.numpy(), df_want)
    _close(w_t.grad.numpy(), dw_want)


def test_k2_twin_matches_pallas_k2(plan):
    """Against the Pallas ``_bwd_kernel`` itself, in interpret mode on the
    per-sample localised plan of level 1."""
    port_plan, caps = plan
    lv = port_plan.levels[1]
    v = lv.valid.shape[0]
    feats, w, g = _inputs(7, v, 16, 16)
    old = scp._INTERPRET
    scp._INTERPRET = True
    try:
        lr, ls = scp.localize_plan(jnp.asarray(lv.ranks.numpy()),
                                   jnp.asarray(lv.sel.numpy()), caps[1], S)
        df_want, dw_want = _jax_vjp(
            lambda f, w_: scp.submanifold_conv_wide_pallas(f, lr, ls, w_,
                                                           caps[1], S),
            feats, w, g)
    finally:
        scp._INTERPRET = old
    df, dw = psc.submanifold_conv_wide_bwd_ref(
        torch.from_numpy(g), torch.from_numpy(feats), lv.ranks, lv.sel,
        torch.from_numpy(w))
    _close(df.numpy(), df_want)
    _close(dw.numpy(), dw_want)


def test_function_casts_weight_and_skips_unneeded_d_feats(plan, monkeypatch):
    """The float32 weight is cast to the feature dtype inside the Function,
    so ``d_w`` leaves in float32 while ``d_feats`` keeps the features'
    bfloat16; a feature input that needs no gradient (the stem's all-ones
    point feature) runs no ``d_feats`` at all."""
    lv = plan[0].levels[0]
    v = lv.valid.shape[0]
    feats, w, g = _inputs(3, v, 4, 8)
    wide = psc.WidePlan(lv.ranks, lv.sel)
    f_t = torch.from_numpy(feats).bfloat16().requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out = psc.submanifold_conv_wide(f_t, wide, w_t)
    assert out.dtype == torch.bfloat16
    out.float().backward(torch.from_numpy(g))
    assert f_t.grad.dtype == torch.bfloat16
    assert w_t.grad.dtype == torch.float32

    def no_dfeats(*args):
        raise AssertionError("d_feats computed for an input without grad")

    monkeypatch.setattr(psc, "submanifold_conv_wide_dfeats_ref", no_dfeats)
    w_t.grad = None
    out = psc.submanifold_conv_wide(torch.from_numpy(feats), wide, w_t)
    out.backward(torch.from_numpy(g))
    dw_want = psc.submanifold_conv_wide_dw_ref(
        torch.from_numpy(g), torch.from_numpy(feats), lv.ranks, lv.sel)
    assert torch.equal(w_t.grad, dw_want)


@pytest.mark.parametrize("which", ["dfeats", "dw"])
def test_k2_wrappers_take_only_cuda_tensors(plan, which):
    """K2's wrappers never fall back to the twin: CPU tensors raise before
    any build or launch, and no launch is counted."""
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    lv = plan[0].levels[0]
    v = lv.valid.shape[0]
    g = torch.zeros(v, 16)
    before = dict(scc.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if which == "dfeats":
            scc.submanifold_conv_wide_bwd_dfeats_cuda(
                g, lv.ranks, lv.sel, torch.zeros(27, 8, 16))
        else:
            scc.submanifold_conv_wide_bwd_dw_cuda(g, torch.zeros(v, 8),
                                                  lv.ranks, lv.sel)
    assert scc.launches == before
