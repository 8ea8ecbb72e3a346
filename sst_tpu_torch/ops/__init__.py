"""Sparse primitives: sort/segment ops, voxelization, the sorted segment
reduce kernel, sparse 3D convolution (grids, rulebook, kernel) and top-k
compaction."""
