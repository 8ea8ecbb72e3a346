"""Sparse primitives: sort/segment ops, voxelization, the sorted segment
reduce kernel and top-k compaction."""
