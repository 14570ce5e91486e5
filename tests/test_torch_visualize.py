"""The port's visualisation helpers against ``mopa_tpu``'s.

On seeded inputs, the port's functions fed tensors and JAX's fed numpy
arrays give equal results: every figure saved as a PNG decodes to the same
RGBA pixels, every returned array is equal, every text file (point clouds
without open3d, cuboid wireframes) is byte-equal, and
``turbo_cmap.interpolate`` is equal with and without its range.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from mopa_tpu.data.utils import turbo_cmap as jax_turbo
from mopa_tpu.data.utils import visualize as jax_vis
from mopa_tpu_torch.data.utils import turbo_cmap as port_turbo
from mopa_tpu_torch.data.utils import visualize as port_vis

H, W, N = 40, 64, 300


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "img8": rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
        "idx": np.stack([rng.integers(0, H, N), rng.integers(0, W, N)], -1),
        "labels": rng.integers(-1, 10, N),
        "points": rng.normal(0, 20, (N, 4)).astype(np.float32),
        "depth": rng.uniform(1, 80, N).astype(np.float32),
        "proj_label": rng.integers(-1, 10, (16, 64)),
        "range_depth": rng.uniform(0, 60, (16, 64)).astype(np.float32),
        "sam": rng.integers(-1, 6, (H, W)),
        "labels_2d": rng.integers(0, 11, (H, W)),
        "chw": rng.uniform(0, 1, (3, H, W)).astype(np.float32),
        "proj": np.asarray([[500.0, 0, W / 2, 0], [0, 500.0, H / 2, 0],
                            [0, 0, 1, 0]]),
        "cloud_in_front": np.c_[rng.uniform(-5, 5, (N, 2)),
                                rng.uniform(5, 40, N)].astype(np.float64),
        "centres": rng.normal(0, 5, (3, 3)),
        "extents": rng.uniform(1, 3, (3, 3)),
    }


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rgba(path):
    return np.asarray(Image.open(path).convert("RGBA"))


FIGURES = {
    "points_labels": lambda m, a, f, save: m.draw_points_image_labels(
        f(a["img"]), f(a["idx"]), f(a["labels"]), save=save),
    "points_labels_nuscenes": lambda m, a, f, save:
        m.draw_points_image_labels(f(a["img8"]), f(a["idx"]),
                                   f(a["labels"] % 6),
                                   color_palette_type="NuScenes", save=save),
    "bev_labels": lambda m, a, f, save: m.draw_bird_eye_view(
        f(a["points"]), f(a["labels"]), save=save),
    "bev_height": lambda m, a, f, save: m.draw_bird_eye_view(
        f(a["points"]), save=save),
    "range_labels": lambda m, a, f, save: m.draw_range_image_labels(
        f(a["proj_label"]), save=save),
    "sam_overlay": lambda m, a, f, save: m.show_anns(
        f(a["sam"]), f(a["img"]), save=save),
    "sam_alone": lambda m, a, f, save: m.show_anns(f(a["sam"]), save=save),
    "points_depth": lambda m, a, f, save: m.draw_points_image_depth(
        f(a["img"]), f(a["idx"]), f(a["depth"]), save=save),
}


@pytest.mark.parametrize("name", list(FIGURES))
def test_figures_equal(tmp_path, name):
    a = inputs()
    draw = FIGURES[name]
    out = []
    for tag, module, f in (("jax", jax_vis, np.asarray),
                           ("port", port_vis, _t)):
        path = tmp_path / "{}.png".format(tag)
        ret = draw(module, a, f, str(path))
        out.append((_rgba(path), ret))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    if out[0][1] is not None:
        np.testing.assert_array_equal(out[1][1], out[0][1])


ARRAYS = {
    "normalize_depth": lambda m, a, f: m.normalize_depth(f(a["depth"]), 5,
                                                         50),
    "depth_color": lambda m, a, f: m.depth_color(f(a["depth"])),
    "grep_depth_color": lambda m, a, f: m.grep_depth_color(f(a["depth"])),
    "range_depth": lambda m, a, f: m.draw_range_image_depth(
        f(a["range_depth"])),
    "projection_depth": lambda m, a, f: m.print_projection_plt(
        f(a["idx"]), f(m.depth_color(a["depth"])), (H, W)),
    "projection_labels": lambda m, a, f: m.print_projection_plt(
        f(a["idx"]), f(a["labels"]), (H, W), depth=False),
    "point_image_depth": lambda m, a, f: m.draw_point_image_depth(
        f(a["points"]), f(a["img"]), f(a["idx"]), None),
    "label_overlay_chw": lambda m, a, f: m.image_label_visualizer(
        f(a["labels_2d"]), f(a["chw"]), None),
    "label_overlay_filter": lambda m, a, f: m.image_label_visualizer(
        f(a["labels_2d"]), f(a["img8"]), None, filter=[0, 3, 4]),
    "world_to_img": lambda m, a, f: m.world_to_img(
        f(a["cloud_in_front"]), f(a["proj"]), (W, H), return_idx=True),
    "turbo": lambda m, a, f: (port_turbo if m is port_vis
                              else jax_turbo).interpolate(f(a["depth"])),
    "turbo_range": lambda m, a, f: (port_turbo if m is port_vis
                                    else jax_turbo).interpolate(
        f(a["depth"]), low=10.0, high=30.0),
}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_arrays_equal(name):
    a = inputs(1)
    want = ARRAYS[name](jax_vis, a, np.asarray)
    got = ARRAYS[name](port_vis, a, _t)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_saved_images_and_files(tmp_path):
    """Images written through PIL, point clouds written as ``.xyz`` text
    (no open3d here) and the cuboid ``.obj`` are byte-equal."""
    a = inputs(2)
    for tag, m, f in (("jax", jax_vis, np.asarray), ("port", port_vis, _t)):
        d = tmp_path / tag
        d.mkdir()
        m.draw_range_image_depth(f(a["range_depth"]), save=str(d / "r.png"))
        m.draw_point_image_depth(f(a["points"]), f(a["img"]), f(a["idx"]),
                                 str(d / "p.png"))
        m.image_label_visualizer(f(a["labels_2d"]), f(a["img8"]),
                                 str(d / "l.png"))
        m.debug_visualizer(f(a["points"]), str(d / "c.pcd"))
        m.draw_registered_point([f(a["points"]), f(a["points"][:10])],
                                [f(np.asarray([1.0, 0, 0])), [0, 0, 1.0]],
                                save=str(d))
        m.save_cuboid_centers_to_obj(f(a["centres"]), f(a["extents"]),
                                     str(d / "box.obj"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 7
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
