"""Raw-data converters of the port (counterparts of the JAX package's
``tools/data_converter``): ``waymo_converter`` (tfrecords → the kitti
format, infos and gt.bin) and ``nuscenes_converter`` (nuScenes or Lyft JSON
tables → info pkls). Host code, numpy only."""
