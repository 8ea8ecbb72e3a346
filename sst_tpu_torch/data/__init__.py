"""Host-side datasets of the port (numpy code copied from the JAX
package's ``sst_tpu/data``) and their collation into torch batches."""
