"""Sparse primitives: sort/segment ops, voxelization, the sorted segment
reduce kernel, sparse 3D convolution (grids, rulebook, kernel), top-k
compaction, SST's window plan and the window MHA kernel."""
