"""Work spread over more than one launch or rank: the tiled high-resolution
path (`tiled.py`, one card: one image's tiles in chunks) and the data axis
across ranks (`mesh.py`: each rank its rows of the global batch, the
gradients all-reduced)."""
