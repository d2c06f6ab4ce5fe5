"""Evaluation of the denoiser over more than one launch of the network: the
tiled high-resolution path. One card: nothing here is sharded."""
