"""Host-side data path of the port (numpy code copied from the JAX
package's ``sst_tpu/data``): the native point-prep library, the pipeline
transforms (multi-sweep loading among them), the gt-database sampler, the
datasets (Waymo, KITTI, nuScenes, Lyft, Argo2, CBGS, synthetic), FSD++'s
incremental dataset, the loader and the tracklet dataset, and their
collation into torch batches on the CPU; the Waymo tfrecord reader and
writers (``waymo_proto``); ``format_writers`` writes small seeded sets in
those formats."""
