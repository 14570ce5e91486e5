"""Waymo Open Dataset scan extraction (PyTorch port of
``mopa_tpu/data/waymo/data_extractor.py``; reference
``mopa/data/waymo/data_extractor.py:19-135``).

Reads ``.tfrecord`` sequences and keeps the TOP lidar's first returns of
the frames that carry segmentation labels: per frame ``bin/<n>.bin``
(x, y, z, tanh of the intensity; float32) and ``label/<n>.npy`` (the
semantic ids). The range images' labels are gathered in numpy; reading the
records (TensorFlow) and decoding the frames (``waymo-open-dataset``) need
those packages, imported by :func:`extract_pc`.

Usage: python -m mopa_tpu_torch.data.waymo.data_extractor
         --src_dir <dir of .tfrecord> --out_dir <dir>
"""

import argparse
import glob
import os

import numpy as np


def range_labels(frame, range_images, segmentation_labels, ri_index=0):
    """Per laser (sorted by name): the (N, 2) int32 (instance, semantic)
    labels of the range image's valid pixels (range > 0) in row-major
    order; zeros for a laser without labels."""
    calibrations = sorted(frame.context.laser_calibrations,
                          key=lambda c: c.name)
    point_labels = []
    for c in calibrations:
        range_image = range_images[c.name][ri_index]
        ri = np.asarray(range_image.data, np.float32).reshape(
            tuple(range_image.shape.dims))
        mask = ri[..., 0] > 0
        if c.name in segmentation_labels:
            sl = segmentation_labels[c.name][ri_index]
            pts = np.asarray(sl.data, np.int32).reshape(
                tuple(sl.shape.dims))[mask]
        else:
            pts = np.zeros([int(mask.sum()), 2], np.int32)
        point_labels.append(pts)
    return point_labels


def extract_pc(seq_path, scen_dir):
    """Write the labelled frames of one sequence under ``scen_dir``;
    returns their count."""
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2 as open_dataset
    from waymo_open_dataset.utils import frame_utils

    seq_data = tf.data.TFRecordDataset(seq_path, compression_type="")
    lidar_dir = os.path.join(scen_dir, "bin")
    label_dir = os.path.join(scen_dir, "label")
    os.makedirs(lidar_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    frame_num = 0
    for data in seq_data:
        frame = open_dataset.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        if not frame.lasers[0].ri_return1.segmentation_label_compressed:
            continue
        (range_images, camera_projections, segmentation_labels,
         range_image_top_pose) = \
            frame_utils.parse_range_image_and_camera_projection(frame)
        points, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            keep_polar_features=True)
        # TOP lidar, (range, intensity, elongation, x, y, z) with polar feats
        pts = points[0]
        xyz_i = np.concatenate(
            [pts[:, 3:6], np.tanh(pts[:, 1]).reshape(-1, 1)], axis=1)
        labels = range_labels(frame, range_images, segmentation_labels)[0][:, 1]

        xyz_i.astype(np.float32).tofile(
            os.path.join(lidar_dir, "{:05d}.bin".format(frame_num)))
        np.save(os.path.join(label_dir, "{:05d}.npy".format(frame_num)), labels)
        frame_num += 1
    return frame_num


def main(argv=None):
    parser = argparse.ArgumentParser(description="Waymo scan extraction")
    parser.add_argument("--src_dir", required=True,
                        help="directory of .tfrecord sequences")
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args(argv)
    for seq_path in sorted(glob.glob(os.path.join(args.src_dir, "*.tfrecord"))):
        name = os.path.splitext(os.path.basename(seq_path))[0]
        scen_dir = os.path.join(args.out_dir, name)
        n = extract_pc(seq_path, scen_dir)
        print("{}: {} labeled frames".format(name, n))


if __name__ == "__main__":
    main()
