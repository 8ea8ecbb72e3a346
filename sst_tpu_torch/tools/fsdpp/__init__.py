"""FSD++'s offline seed tools on the port (counterparts of the JAX
package's ``tools/fsdpp``), each run as ``python -m
sst_tpu_torch.tools.fsdpp.<name>``: ``generate_seeds`` (a detection bin →
seeds keyed by (context, timestamp)), ``create_seed_boxes_from_bin`` /
``_from_info`` / ``_from_raw_output`` (seeds keyed by image index from a
bin, the gt annotations or a ``tools.test --out`` dump) and
``create_segment_break`` (shards of whole sequences)."""
