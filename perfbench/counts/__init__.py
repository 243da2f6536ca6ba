"""Frozen operation and byte counts of the port's kernels, and the table
of peaks they are held against: the least time a kernel can take on the
card, per call, from what its inputs need."""
