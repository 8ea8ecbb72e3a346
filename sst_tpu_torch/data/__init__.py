"""Host-side data path of the port (numpy code copied from the JAX
package's ``sst_tpu/data``): the native point-prep library, the pipeline
transforms, the datasets, the loader and the tracklet dataset, and their
collation into torch batches on the CPU."""
