"""Visualisation helpers (port of ``mopa_tpu/data/utils/visualize.py``;
reference ``mopa/data/utils/visualize.py:229-670``).

Color palettes for nuScenes / SemanticKITTI / Waymo merged classes, point-on-
image label drawing, range-image rendering, SAM overlay and BEV scatter, on
the host: matplotlib (Agg backend) and open3d are imported lazily, open3d
only where a point cloud is written (a plain ``.xyz`` text file without it).
Array arguments may be tensors on any device; each is copied to the host
(``.cpu().numpy()``) where the function receives it.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    """A tensor's values as numpy (anything else as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x

# merged-class palettes (RGB 0-255)
NUSCENES_COLOR_PALETTE = [
    (255, 158, 0),   # vehicle
    (0, 0, 230),     # pedestrian
    (255, 61, 99),   # bike
    (112, 128, 144), # traffic boundary
    (50, 205, 50),   # background
    (0, 0, 0),       # ignore
]

SEMANTIC_KITTI_COLOR_PALETTE = [
    (100, 150, 245),  # car
    (80, 30, 180),    # truck
    (30, 60, 150),    # bike
    (255, 30, 30),    # person
    (255, 0, 255),    # road
    (255, 150, 255),  # parking
    (75, 0, 75),      # sidewalk
    (0, 200, 255),    # building
    (0, 175, 0),      # nature
    (255, 240, 150),  # other-objects
    (0, 0, 0),        # ignore
]

WAYMO_COLOR_PALETTE = SEMANTIC_KITTI_COLOR_PALETTE

_PALETTES = {
    "NuScenes": NUSCENES_COLOR_PALETTE,
    "SemanticKITTI": SEMANTIC_KITTI_COLOR_PALETTE,
    "Waymo": WAYMO_COLOR_PALETTE,
}


def _palette(color_palette_type):
    return np.asarray(_PALETTES[color_palette_type], np.uint8)


def draw_points_image_labels(img, img_indices, seg_labels,
                             color_palette_type="SemanticKITTI",
                             point_size=2, save=None, show=False):
    """Scatter per-point class colors over the image (reference :229-280)."""
    img, img_indices = _host(img), _host(img_indices)
    seg_labels = _host(seg_labels)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    palette = _palette(color_palette_type)
    labels = np.asarray(seg_labels).astype(int)
    labels = np.where(labels < 0, len(palette) - 1, labels)
    colors = palette[np.clip(labels, 0, len(palette) - 1)] / 255.0

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(np.asarray(img))
    ax.scatter(img_indices[:, 1], img_indices[:, 0], c=colors, s=point_size)
    ax.axis("off")
    if save:
        fig.savefig(save, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)


def draw_bird_eye_view(points, seg_labels=None,
                       color_palette_type="SemanticKITTI", xlim=60, ylim=60,
                       save=None):
    """BEV scatter of a scan (reference draw_bird_eye_view)."""
    points, seg_labels = _host(points), _host(seg_labels)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if seg_labels is not None:
        palette = _palette(color_palette_type)
        labels = np.where(np.asarray(seg_labels) < 0, len(palette) - 1,
                          seg_labels).astype(int)
        c = palette[np.clip(labels, 0, len(palette) - 1)] / 255.0
    else:
        c = points[:, 2]
    ax.scatter(points[:, 0], points[:, 1], c=c, s=0.5)
    ax.set_xlim(-xlim, xlim)
    ax.set_ylim(-ylim, ylim)
    ax.set_aspect("equal")
    if save:
        fig.savefig(save, bbox_inches="tight")
    plt.close(fig)


def draw_range_image_labels(proj_label, color_palette_type="SemanticKITTI",
                            save=None):
    """Render a label range image (reference draw_range_image_labels)."""
    proj_label = _host(proj_label)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    palette = _palette(color_palette_type)
    lab = np.where(proj_label < 0, len(palette) - 1, proj_label).astype(int)
    img = palette[np.clip(lab, 0, len(palette) - 1)]
    fig, ax = plt.subplots(figsize=(16, 2))
    ax.imshow(img)
    ax.axis("off")
    if save:
        fig.savefig(save, bbox_inches="tight")
    plt.close(fig)


def show_anns(sam_mask, image=None, save=None):
    """Overlay SAM mask ids with random colors (reference show_anns)."""
    sam_mask, image = _host(sam_mask), _host(image)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    ids = np.unique(sam_mask[sam_mask >= 0])
    overlay = np.zeros(sam_mask.shape + (3,), np.float32)
    for i in ids:
        overlay[sam_mask == i] = rng.random(3)
    fig, ax = plt.subplots(figsize=(10, 6))
    if image is not None:
        ax.imshow(np.asarray(image))
        ax.imshow(overlay, alpha=0.6)
    else:
        ax.imshow(overlay)
    ax.axis("off")
    if save:
        fig.savefig(save, bbox_inches="tight")
    plt.close(fig)


def save_pcd(points, colors=None, path="out.pcd"):
    """Dump a point cloud via open3d when available (reference debug dumps)."""
    points, colors = _host(points), _host(colors)
    try:
        import open3d as o3d
    except ImportError:
        # plain xyz text fallback
        np.savetxt(path + ".xyz", np.asarray(points))
        return
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(np.asarray(points, np.float64))
    if colors is not None:
        pc.colors = o3d.utility.Vector3dVector(np.asarray(colors, np.float64))
    o3d.io.write_point_cloud(path, pc)


# --------------------------------------------------------------------------- #
# Depth-coloured projections (reference visualize.py:262-428)
# --------------------------------------------------------------------------- #

def normalize_depth(depth, d_min, d_max):
    """Linear [0, 1] normalisation clipped to [d_min, d_max]."""
    depth = _host(depth)
    return (np.clip(depth, d_min, d_max) - d_min) / (d_max - d_min)


def depth_color(val, min_d=0, max_d=120):
    """HSV hue per distance: near = red (0), far = blue (120)."""
    val = _host(val)
    val = np.clip(np.asarray(val, np.float64), 0, max_d)
    return (((val - min_d) / (max_d - min_d)) * 120).astype(np.uint8)


def grep_depth_color(val, min_d=0, max_d=50):
    """Greyscale intensity per distance: near = bright, far = dark."""
    val = _host(val)
    val = np.clip(np.asarray(val, np.float64), 0, max_d)
    return ((max_d - val) / (max_d - min_d)) * 255


def draw_points_image_depth(img, img_indices, depth, point_size=0.5,
                            save=None, show=False):
    """Scatter points over the image coloured by depth (near=red, far=blue,
    reference draw_points_image_depth)."""
    img, img_indices, depth = (_host(img), _host(img_indices),
                               _host(depth))
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt

    hue = depth_color(depth).astype(np.float32) / 179.0
    hsv = np.stack([hue, np.ones_like(hue), np.ones_like(hue)], -1)
    colors = mcolors.hsv_to_rgb(hsv)
    fig, ax = plt.subplots(
        figsize=(np.asarray(img).shape[1] / 100,
                 np.asarray(img).shape[0] / 100))
    ax.imshow(np.asarray(img))
    ax.scatter(img_indices[:, 1], img_indices[:, 0], c=colors, alpha=0.7,
               s=point_size)
    ax.axis("off")
    if save:
        fig.savefig(save, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return colors


def draw_range_image_depth(depth, save=None):
    """Greyscale range-image render (reference draw_range_image_depth)."""
    depth = _host(depth)
    grey = grep_depth_color(depth).astype(np.uint8)
    if save:
        from PIL import Image

        Image.fromarray(grey, "L").save(save)
    return grey


def print_projection_plt(points, color, img_size, depth=True):
    """Rasterise projected points ((row, col) layout) onto a blank image:
    HSV depth hues, or the class palette (reference print_projection_plt)."""
    points, color = _host(points), _host(color)
    h, w = img_size[:2]
    out_hsv = np.zeros((h, w, 3), np.uint8)
    rr = np.clip(np.asarray(points[:, 0], np.int32), 0, h - 1)
    cc = np.clip(np.asarray(points[:, 1], np.int32), 0, w - 1)
    if depth:
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                y = np.clip(rr + dy, 0, h - 1)
                x = np.clip(cc + dx, 0, w - 1)
                out_hsv[y, x, 0] = np.asarray(color, np.uint8)
                out_hsv[y, x, 1] = 255
                out_hsv[y, x, 2] = 255
        import matplotlib.colors as mcolors

        rgb = mcolors.hsv_to_rgb(out_hsv.astype(np.float32)
                                 / np.asarray([179.0, 255.0, 255.0]))
        return (rgb * 255).astype(np.uint8)
    palette = _palette("SemanticKITTI")
    out = np.zeros((h, w, 3), np.uint8)
    lab = np.asarray(color, np.int64)
    ok = (lab >= 0) & (lab < len(palette) - 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            y = np.clip(rr[ok] + dy, 0, h - 1)
            x = np.clip(cc[ok] + dx, 0, w - 1)
            out[y, x] = palette[lab[ok]]
    return out


def draw_point_image_depth(pc, image, img_indices, save_pth):
    """Depth-coloured projection blended onto the camera image
    (reference draw_point_image_depth)."""
    pc, image, img_indices = _host(pc), _host(image), _host(img_indices)
    dist = np.linalg.norm(np.asarray(pc)[:, :3], axis=1)
    c = depth_color(dist, dist.min(), float(dist.max()))
    layer = print_projection_plt(np.asarray(img_indices),
                                 c, np.asarray(image).shape)
    img8 = np.asarray(image)
    if img8.dtype != np.uint8:
        img8 = (np.clip(img8, 0, 1) * 255).astype(np.uint8)
    blend = (0.5 * img8 + 0.5 * layer + 1.0).clip(0, 255).astype(np.uint8)
    if save_pth:
        from PIL import Image

        Image.fromarray(blend).save(save_pth)
    return blend


def image_label_visualizer(labels_2d, raw_image, save_pth, filter=None):
    """Dense per-pixel label overlay on the image, optionally restricted to a
    class-id ``filter`` list (reference image_label_visualizer). ``raw_image``
    is CHW in [0, 1] like the reference, or HWC."""
    labels_2d, raw_image = _host(labels_2d), _host(raw_image)
    palette = np.asarray(SEMANTIC_KITTI_COLOR_PALETTE, np.uint8)
    if filter is not None:
        keep = np.zeros(len(palette), bool)
        keep[np.asarray(filter, int)] = True
        palette = np.where(keep[:, None], palette, palette[-1])
    lab = np.clip(np.asarray(labels_2d, np.int64), 0, len(palette) - 1)
    logit_color = palette[lab]
    img = np.asarray(raw_image)
    if (img.ndim == 3 and img.shape[0] in (1, 3)
            and img.shape[0] < img.shape[-1]):
        img = np.transpose(img, (1, 2, 0))
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    blend = (0.6 * img + 0.4 * logit_color + 1.0).clip(0, 255).astype(np.uint8)
    if save_pth:
        from PIL import Image

        Image.fromarray(blend).save(save_pth)
    return blend


def world_to_img(pc_array, intrin_mtx, img_size, return_idx=False):
    """Project world points through a 3x4 matrix; keep in-frustum points and
    return (points, (row, col) pixel coords[, keep_index])."""
    pc_array, intrin_mtx = _host(pc_array), _host(intrin_mtx)
    hom = np.concatenate(
        [pc_array, np.ones([pc_array.shape[0], 1], pc_array.dtype)], axis=1)
    img_points = (np.asarray(intrin_mtx) @ hom.T).T
    img_points = img_points[:, :2] / img_points[:, 2:3]
    w, h = img_size[0], img_size[1]
    keep = ((img_points[:, 0] > 0) & (img_points[:, 0] < w)
            & (img_points[:, 1] > 0) & (img_points[:, 1] < h))
    if not return_idx:
        return pc_array[keep], np.fliplr(img_points[keep])
    return pc_array[keep], np.fliplr(img_points[keep]), keep


# --------------------------------------------------------------------------- #
# Point-cloud debug dumps (reference visualize.py:347-377, 437-504)
# --------------------------------------------------------------------------- #

def debug_visualizer(pc, save_pth, pc_color=None):
    """Dump a (colored) point cloud for external inspection
    (reference debug_visualizer; open3d optional)."""
    pc, pc_color = _host(pc), _host(pc_color)
    save_pcd(np.asarray(pc)[:, :3], colors=pc_color, path=save_pth)
    return 0


def draw_registered_point(pc_ls, color_ls, vis=False, save=None):
    """Co-registered point clouds painted with uniform per-cloud colors;
    written as pcds under ``save`` and/or shown interactively
    (reference draw_registered_point)."""
    clouds = []
    try:
        import open3d as o3d
    except ImportError:
        o3d = None
    for i, pc in enumerate(pc_ls):
        pc = _host(pc)
        color = np.asarray(_host(color_ls[i]), np.float64)
        if o3d is None:
            if save:
                save_pcd(np.asarray(pc)[:, :3],
                         colors=np.tile(color, (len(pc), 1)),
                         path="{}/{:05d}.pcd".format(save, i))
            continue
        cloud = o3d.geometry.PointCloud()
        cloud.points = o3d.utility.Vector3dVector(
            np.asarray(pc)[:, :3].astype(np.float64))
        cloud.estimate_normals()
        cloud.paint_uniform_color(color)
        clouds.append(cloud)
        if save:
            o3d.io.write_point_cloud("{}/{:05d}.pcd".format(save, i), cloud)
    if vis and o3d is not None:
        o3d.visualization.draw_geometries(clouds)
    return clouds


def save_cuboid_centers_to_obj(cuboid_centers, extents, filename):
    """Write cuboids (centers + half-extent corners) as a wireframe .obj
    (reference save_cuboid_centers_to_obj)."""
    cuboid_centers, extents = _host(cuboid_centers), _host(extents)
    corners_unit = np.array([[sx, sy, sz] for sx in (-1, 1)
                             for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    lines = []
    vi = 1
    edges = [(0, 1), (0, 2), (1, 3), (2, 3),
             (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    with open(filename, "w") as f:
        for center, ext in zip(np.asarray(cuboid_centers),
                               np.asarray(extents)):
            corners = center + corners_unit * np.asarray(ext) / 2.0
            for cxyz in corners:
                f.write("v {} {} {}\n".format(*cxyz))
            for a, b in edges:
                lines.append((vi + a, vi + b))
            vi += 8
        for a, b in lines:
            f.write("l {} {}\n".format(a, b))
