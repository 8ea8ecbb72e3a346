"""CTRL's offline chain on the port (counterparts of the JAX package's
``tools/ctrl``), each run as ``python -m sst_tpu_torch.tools.ctrl.<name>``:
``extract_poses`` (pose, timestamp and frame tables from the kitti-format
infos), ``generate_train_gt_bin`` (a gt Objects bin from tfrecords),
``generate_track_input`` (a tracker's bin → world-frame tracklets),
``generate_candidates`` (one gt box per tracklet frame),
``extend_tracks`` (constant-velocity extension), ``merge_bins`` and
``remove_empty`` (boxes with no point dropped)."""
