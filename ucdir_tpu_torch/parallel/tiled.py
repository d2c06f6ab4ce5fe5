"""Tiled high-resolution evaluation of the denoiser. Counterpart of
`ucdir_tpu/parallel/tiled.py` (reference: utils/util.py:108-146
`patch_forward_guide`, called from model/ucdir.py:295-300).

Inside EVERY denoising step an input larger than `skip` x `skip` is split
into overlapping tiles with `padding`-px halos, each tile runs through the
UNet, and the halo-cropped centers are reassembled, so the diffusion state
stays consistent across the whole image between steps and no seams appear.

Edge semantics, the reference's:
  * a reflect pre-pad of `padding` px on all sides (more when the image is
    smaller than a tile, `_grid_pad`);
  * tiles start every `skip - 2 * padding` px; a tile that overflows snaps to
    the end;
  * centers are written in loop order, later (snapped) tiles overwriting
    earlier ones.

The JAX package maps the network over chunks of tiles inside one program and
shards each chunk over a mesh's data axis. Here the chunks are a Python
loop; under a process group (`distributed`) a chunk of tile_chunk tiles is
split over the ranks, rank r taking tiles [r * k, (r + 1) * k) of it (k =
tile_chunk / world, the mesh's one tile a device at k = 1), and the ranks
all-gather the halo-cropped centers once a step. Every rank then holds the
whole output.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from ucdir_tpu_torch.models.dy3h import compute_guide_maps
from ucdir_tpu_torch.models.layers import reflect_pad
from ucdir_tpu_torch.parallel.mesh import _backend_device


def compute_tile_starts(H: int, W: int, skip: int, padding: int
                        ) -> List[Tuple[int, int]]:
    """(h_start, w_start) of every tile, overflowing ones snapped to the end.
    H, W are the sizes AFTER the reflect pre-pad."""
    shift = skip - padding * 2
    starts = []
    for i in range(0, H, shift):
        h_start = H - skip if i + skip > H else i
        for j in range(0, W, shift):
            starts.append((h_start, W - skip if j + skip > W else j))
    return starts


def _grid_pad(h: int, w: int, skip: int, padding: int) -> int:
    """Width of the reflect pre-pad: `padding`, or what brings an image
    smaller than a tile up to one tile plus the halo."""
    pd = min(h, w)
    return skip - pd + padding if pd < skip else padding


def _extract_tiles(x_padded, starts, skip: int):
    """The tiles at `starts`, concatenated along the batch axis (tile-major):
    (len(starts) * B, skip, skip, C)."""
    return torch.cat([x_padded[:, hs:hs + skip, ws:ws + skip, :]
                      for hs, ws in starts], dim=0)


def _reassemble(out_tiles, starts, b: int, H: int, W: int, padding: int,
                pd: int):
    """out_tiles (len(starts) * B, skip, skip, C), tile-major: the centers
    written in order (later tiles overwrite), then the pre-pad cropped."""
    return _reassemble_centers(out_tiles[:, padding:-padding,
                                         padding:-padding],
                               starts, b, H, W, padding, pd)


def _reassemble_centers(centers, starts, b: int, H: int, W: int,
                        padding: int, pd: int):
    """`_reassemble` of the halo-cropped centers (len(starts) * B,
    skip - 2 * padding, skip - 2 * padding, C)."""
    denoised = centers.new_zeros((b, H, W, centers.shape[-1]))
    S = centers.shape[1]
    for t, (hs, ws) in enumerate(starts):
        denoised[:, hs + padding:hs + padding + S,
                 ws + padding:ws + padding + S] = centers[t * b:(t + 1) * b]
    return denoised[:, pd:-pd, pd:-pd, :]


def _chunks(starts, tile_chunk: int):
    return [starts[i:i + tile_chunk]
            for i in range(0, len(starts), tile_chunk)]


def rank_chunks(n_tiles: int, tile_chunk: int, rank: int, world: int
                ) -> List[List[int]]:
    """The tile indices a rank evaluates, per chunk: of chunk j (tiles
    [j * tile_chunk, (j + 1) * tile_chunk), the count padded with dummies),
    the rank's k = tile_chunk / world consecutive ones, dummies dropped.
    Every rank has n_chunks * k slots."""
    if tile_chunk % world:
        raise ValueError('tile_chunk %d does not split over %d ranks'
                         % (tile_chunk, world))
    k = tile_chunk // world
    n_chunks = -(-n_tiles // tile_chunk)
    return [[t for t in range(j * tile_chunk + rank * k,
                              j * tile_chunk + (rank + 1) * k)
             if t < n_tiles] for j in range(n_chunks)]


def _gather_centers(centers, chunks, n_tiles: int, b: int, world: int,
                    k: int):
    """Every rank's halo-cropped centers (its `chunks`' tiles, tile-major)
    all-gathered once: returns the centers of all n_tiles tiles in tile
    order, on every rank."""
    slots = len(chunks) * k
    dev = _backend_device(centers)
    send = centers.new_zeros((slots * b,) + tuple(centers.shape[1:]))
    pos = 0
    for j, c in enumerate(chunks):
        send[j * k * b:(j * k + len(c)) * b] = centers[pos:pos + len(c) * b]
        pos += len(c) * b
    send = send.to(dev)
    got = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(got, send)
    tile_chunk = k * world
    out = []
    for t in range(n_tiles):
        j, i = divmod(t, tile_chunk)
        r, i = divmod(i, k)
        slot = j * k + i
        out.append(got[r][slot * b:(slot + 1) * b])
    return torch.cat(out, dim=0).to(centers.device)


def patch_forward_guide(fn: Callable, noisy, guide, skip: int = 1024,
                        padding: int = 64, tile_chunk: int = 1):
    """Tiled evaluation of `fn` over `noisy` (NHWC, any C) with `guide` tiled
    in lockstep. fn: (tiles (k, skip, skip, C), guide tiles (k, skip, skip,
    Cg)) -> (k, skip, skip, Cout), called on chunks of `tile_chunk` tiles."""
    b, h, w, _ = noisy.shape
    pd = _grid_pad(h, w, skip, padding)
    noisy = reflect_pad(noisy, pd, pd, pd, pd)
    guide = reflect_pad(guide, pd, pd, pd, pd)
    H, W = noisy.shape[1], noisy.shape[2]
    starts = compute_tile_starts(H, W, skip, padding)
    out = torch.cat([fn(_extract_tiles(noisy, c, skip),
                        _extract_tiles(guide, c, skip))
                     for c in _chunks(starts, tile_chunk)], dim=0)
    return _reassemble(out, starts, b, H, W, padding, pd)


def tiled_denoise_fn(denoiser, x_cond, guide, skip: int = 1024,
                     padding: int = 64, tile_chunk: int = 1,
                     distributed: bool = False) -> Callable:
    """`denoise(img, noise_level) -> eps` whose UNet evaluation is tiled: a
    drop-in for the samplers of ucdir_tpu_torch.diffusion. denoiser: the DY3h
    module; x_cond (B, H, W, 3) the condition; guide (B, H, W, 3).
    distributed: the tiles over the ranks of the process group, every rank
    calling with the same inputs (`rank_chunks`); each gets the whole eps.

    What does not change over the reverse process is done once here, not per
    step: the padded condition, and every tile's guide-attention maps (the
    reference reruns the guide convs in every step). The noise level of
    sample 0 serves every tile, as in the JAX package."""
    b, h, w, _ = x_cond.shape
    pd = _grid_pad(h, w, skip, padding)
    xc_pad = reflect_pad(x_cond, pd, pd, pd, pd)
    g_pad = reflect_pad(guide, pd, pd, pd, pd)
    H, W = xc_pad.shape[1], xc_pad.shape[2]
    starts = compute_tile_starts(H, W, skip, padding)
    # under a process group the centers are gathered, on a group of one
    # rank too
    if distributed and dist.is_initialized():
        world = dist.get_world_size()
        ids = rank_chunks(len(starts), tile_chunk, dist.get_rank(), world)
        chunks = [[starts[t] for t in c] for c in ids]
    else:
        chunks = _chunks(starts, tile_chunk)
        ids = None
    maps = [compute_guide_maps(denoiser, _extract_tiles(g_pad, c, skip))
            if c else None for c in chunks]
    del g_pad

    def denoise(img, noise_level):
        img_pad = reflect_pad(img, pd, pd, pd, pd)
        outs = []
        for c, m in zip(chunks, maps):
            if not c:
                continue
            net = torch.cat([_extract_tiles(xc_pad, c, skip),
                             _extract_tiles(img_pad, c, skip)], dim=-1)
            nl = noise_level[:1].expand(net.shape[0], noise_level.shape[1])
            # every block finds its maps in m: the guide image is not read
            outs.append(denoiser.naiveforward(net, nl, net[..., :3],
                                              guide_maps=m))
        if ids is None:
            return _reassemble(torch.cat(outs, dim=0), starts, b, H, W,
                               padding, pd)
        mine = (torch.cat(outs, dim=0)[:, padding:-padding,
                                       padding:-padding] if outs else
                img.new_zeros((0, skip - 2 * padding, skip - 2 * padding,
                               img.shape[-1])))
        centers = _gather_centers(mine, ids, len(starts), b, world,
                                  tile_chunk // world)
        return _reassemble_centers(centers, starts, b, H, W, padding, pd)

    return denoise
