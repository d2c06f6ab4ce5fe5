"""The tile-resident reverse process: the diffusion state stays tiled across
all T steps. Counterpart of `ucdir_tpu/parallel/resident.py`.

The reassembling path (parallel/tiled.py, the reference's utils/util.py:
108-146 inside every step) pads the full state, cuts every tile, runs the
UNet, writes the centers back and updates the whole image, every step. Here
the state lives as the tile windows for the whole reverse process. In each
step every tile
  1. runs the UNet on its window;
  2. applies the ancestral update only on its OWNED region, the part of the
     canvas where it is the reference's last writer (later tiles overwrite
     earlier ones, so ownership is the write-order partition of the canvas
     interior);
  3. receives every other pixel of its window from the owning tile (fixed
     window-to-window copies; the reflect-pad frame of the canvas is served
     by flipped copies of interior owners).
Each pixel is updated once, by its owner, with the noise drawn over the whole
image, and every window then equals its slice of the padded state, so the
tiles' inputs, and with them the whole reverse process, are the reassembling
path's bit for bit.

Over ranks (a `torch.distributed` process group): the tiles are chunked
device-major as in the JAX package, tile t on device t // n_chunks, and a
rank holds tile_chunk / world devices, so with tile_chunk == world rank d
owns tiles [d * n_chunks, (d + 1) * n_chunks). A rank runs the UNet on its
own tiles only (their guide maps computed once per image), updates their
owned regions, copies its own overlaps in place and exchanges the others
with `torch.distributed.batch_isend_irecv`, one packed buffer per peer (the
JAX package's one `lax.ppermute` per device offset). No step gathers the
image: the final image and the snapshots are gathered once, at the end,
onto every rank. Every rank draws the whole image's noise from one shared
stream and keeps its owned regions. gloo sends host tensors only, so there
the buffers go through host memory (which also lets ranks share a card).

The windows are natural NHWC, (tiles, b, skip, skip, C): the JAX package's
flat carry exists to fill the TPU's 128 vector lanes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
import torch.distributed as dist

from ucdir_tpu_torch.models.dy3h import compute_guide_maps
from ucdir_tpu_torch.models.layers import reflect_pad
from ucdir_tpu_torch.parallel.mesh import _backend_device
from ucdir_tpu_torch.parallel.tiled import _grid_pad

Rect = Tuple[int, int, int, int]


def _starts_1d(size: int, skip: int, padding: int) -> List[int]:
    """Tile starts along one axis in the reference's loop order (they may
    repeat or step backwards at the snapped end, utils/util.py:129-135)."""
    shift = skip - padding * 2
    return [i if i + skip <= size else size - skip
            for i in range(0, size, shift)]


def _owner_intervals(starts: Sequence[int], skip: int, padding: int
                     ) -> List[Tuple[int, int, int]]:
    """[padding, size - padding) cut into (lo, hi, owner): the owner is the
    LAST tile in loop order whose center [s + padding, s + skip - padding)
    covers the interval (later tiles overwrite)."""
    edges = sorted({s + padding for s in starts}
                   | {s + skip - padding for s in starts})
    out: List[Tuple[int, int, int]] = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        mid = (lo + hi) // 2
        owners = [i for i, s in enumerate(starts)
                  if s + padding <= mid < s + skip - padding]
        if not owners:
            continue
        if out and out[-1][2] == owners[-1] and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi, owners[-1])
        else:
            out.append((lo, hi, owners[-1]))
    return out


class Copy(NamedTuple):
    """One fixed window-to-window copy: tile dst_t's rect dst <- tile src_t's
    rect src, flipped along rows and/or columns (window coordinates,
    [r0, r1, c0, c1))."""
    dst_t: int
    dst: Rect
    src_t: int
    src: Rect
    flip_r: bool
    flip_c: bool


class ResidentPlan:
    """The fixed geometry of a tile-resident reverse process for an h x w
    state: the canvas is the state reflect-padded by pd, as in
    parallel/tiled.py. Plain Python over integers."""

    def __init__(self, h: int, w: int, skip: int = 1024, padding: int = 64):
        self.h, self.w = h, w
        self.skip, self.padding = skip, padding
        pd = self.pd = _grid_pad(h, w, skip, padding)
        H, W = self.H, self.W = h + 2 * pd, w + 2 * pd
        if H < 3 * pd + 1 or W < 3 * pd + 1:
            raise ValueError('canvas %d x %d too small for the reflect '
                             'frame (pd=%d)' % (H, W, pd))
        self.hs = _starts_1d(H, skip, padding)
        self.ws = _starts_1d(W, skip, padding)
        self.n_rows, self.n_cols = len(self.hs), len(self.ws)
        self.n_tiles = self.n_rows * self.n_cols
        # rows outer, columns inner: parallel/tiled.compute_tile_starts
        self.starts = [(a, b) for a in self.hs for b in self.ws]

        # ownership spans [padding, S - padding); the interior is
        # [pd, S - pd), a subset where the image is smaller than a tile
        def clip(bands, S):
            return [(max(lo, pd), min(hi, S - pd), o)
                    for (lo, hi, o) in bands if min(hi, S - pd) > max(lo, pd)]
        self.rbands = clip(_owner_intervals(self.hs, skip, padding), H)
        self.cbands = clip(_owner_intervals(self.ws, skip, padding), W)
        if (self.rbands[0][0] != pd or self.rbands[-1][1] != H - pd
                or self.cbands[0][0] != pd or self.cbands[-1][1] != W - pd):
            raise AssertionError('ownership does not cover the interior')
        # each tile's owned rect in canvas coordinates (none for a tile
        # that a later one shadows)
        self.owned: Dict[int, Rect] = {}
        for (rlo, rhi, ri) in self.rbands:
            for (clo, chi, cj) in self.cbands:
                self.owned[ri * self.n_cols + cj] = (rlo, rhi, clo, chi)
        self.copies = self._build_copies()

    def _interior_cells(self):
        for (rlo, rhi, ri) in self.rbands:
            for (clo, chi, cj) in self.cbands:
                yield (rlo, rhi, clo, chi), ri * self.n_cols + cj

    def _frame_pieces(self):
        """(dst rect, src rect, owner, flip_r, flip_c): the canvas frame's
        rects and their reflect sources, cut so that each source lies in one
        owner's band (reflect: i < pd reads 2 * pd - i, i >= S - pd reads
        2 * (S - pd - 1) - i)."""
        H, W, pd = self.H, self.W, self.pd

        def zones(S):
            return [(0, pd, -1), (pd, S - pd, 0), (S - pd, S, 1)]

        def src_range(lo, hi, kind, S):
            if kind == 0:
                return lo, hi, False
            if kind == -1:
                return 2 * pd - hi + 1, 2 * pd - lo + 1, True
            return 2 * (S - pd - 1) - hi + 1, 2 * (S - pd - 1) - lo + 1, True

        def mirror(s0, s1, kind, S):
            if kind == -1:
                return 2 * pd - s1 + 1, 2 * pd - s0 + 1
            return 2 * (S - pd - 1) - s1 + 1, 2 * (S - pd - 1) - s0 + 1

        def split_by(bands, lo, hi):
            for (blo, bhi, owner) in bands:
                s, e = max(lo, blo), min(hi, bhi)
                if s < e:
                    yield s, e, owner

        for (rlo, rhi, rkind) in zones(H):
            for (clo, chi, ckind) in zones(W):
                if rkind == 0 and ckind == 0:
                    continue
                srlo, srhi, fr = src_range(rlo, rhi, rkind, H)
                sclo, schi, fc = src_range(clo, chi, ckind, W)
                for (sr0, sr1, ri) in split_by(self.rbands, srlo, srhi):
                    for (sc0, sc1, cj) in split_by(self.cbands, sclo, schi):
                        dr0, dr1 = (mirror(sr0, sr1, rkind, H) if fr
                                    else (sr0, sr1))
                        dc0, dc1 = (mirror(sc0, sc1, ckind, W) if fc
                                    else (sc0, sc1))
                        yield ((dr0, dr1, dc0, dc1), (sr0, sr1, sc0, sc1),
                               ri * self.n_cols + cj, fr, fc)

    def _build_copies(self) -> List[Copy]:
        """Every fixed copy that refreshes a window's non-owned pixels once
        the owned regions are updated."""
        copies: List[Copy] = []

        def clip_to_window(t, rect):
            hs, ws = self.starts[t]
            r0, r1 = max(rect[0], hs), min(rect[1], hs + self.skip)
            c0, c1 = max(rect[2], ws), min(rect[3], ws + self.skip)
            return None if r0 >= r1 or c0 >= c1 else (r0, r1, c0, c1)

        for t in range(self.n_tiles):
            hs, ws = self.starts[t]
            for rect, owner in self._interior_cells():
                if owner == t:
                    continue
                dst = clip_to_window(t, rect)
                if dst is None:
                    continue
                ohs, ows = self.starts[owner]
                copies.append(Copy(
                    t, (dst[0] - hs, dst[1] - hs, dst[2] - ws, dst[3] - ws),
                    owner, (dst[0] - ohs, dst[1] - ohs,
                            dst[2] - ows, dst[3] - ows), False, False))
            # the frame, its pieces owned by t included
            for dst_rect, src_rect, owner, fr, fc in self._frame_pieces():
                dst = clip_to_window(t, dst_rect)
                if dst is None:
                    continue
                # crop the source as the clip cropped the destination (a
                # flip swaps the ends)
                r_lo, r_hi = dst[0] - dst_rect[0], dst_rect[1] - dst[1]
                c_lo, c_hi = dst[2] - dst_rect[2], dst_rect[3] - dst[3]
                sr0, sr1, sc0, sc1 = src_rect
                sr0, sr1 = ((sr0 + r_hi, sr1 - r_lo) if fr
                            else (sr0 + r_lo, sr1 - r_hi))
                sc0, sc1 = ((sc0 + c_hi, sc1 - c_lo) if fc
                            else (sc0 + c_lo, sc1 - c_hi))
                ohs, ows = self.starts[owner]
                copies.append(Copy(
                    t, (dst[0] - hs, dst[1] - hs, dst[2] - ws, dst[3] - ws),
                    owner, (sr0 - ohs, sr1 - ohs, sc0 - ows, sc1 - ows),
                    fr, fc))
        return copies

    # -- on tensors: NHWC windows (tiles, b, skip, skip, C) ------------------
    def canvas(self, img):
        """The state (b, h, w, C) reflect-padded by pd."""
        pd = self.pd
        return reflect_pad(img, pd, pd, pd, pd)

    def extract(self, img, tiles: Optional[Sequence[int]] = None):
        """State (b, h, w, C) -> the windows of `tiles` (default all),
        (len(tiles), b, skip, skip, C)."""
        canvas, s = self.canvas(img), self.skip
        tiles = range(self.n_tiles) if tiles is None else tiles
        return torch.stack([canvas[:, hs:hs + s, ws:ws + s]
                            for hs, ws in (self.starts[t] for t in tiles)])

    def owned_window(self, t: int) -> Rect:
        """Tile t's owned rect in its window's coordinates."""
        r0, r1, c0, c1 = self.owned[t]
        hs, ws = self.starts[t]
        return r0 - hs, r1 - hs, c0 - ws, c1 - ws

    def owned_state(self, t: int) -> Rect:
        """Tile t's owned rect in the state's coordinates."""
        r0, r1, c0, c1 = self.owned[t]
        pd = self.pd
        return r0 - pd, r1 - pd, c0 - pd, c1 - pd

    def materialize(self, tw):
        """Windows of every tile -> the state (b, h, w, C), from the owned
        regions."""
        out = tw.new_zeros((tw.shape[1], self.h, self.w, tw.shape[-1]))
        for t in self.owned:
            r0, r1, c0, c1 = self.owned_window(t)
            s0, s1, s2, s3 = self.owned_state(t)
            out[:, s0:s1, s2:s3] = tw[t, :, r0:r1, c0:c1]
        return out

    def update_owned(self, tw, update_fn: Callable):
        """tw with `update_fn(t, values, state rect, window rect)` applied on
        every tile's owned rect, in place."""
        for t in self.owned:
            wr = self.owned_window(t)
            cur = tw[t, :, wr[0]:wr[1], wr[2]:wr[3]]
            tw[t, :, wr[0]:wr[1], wr[2]:wr[3]] = update_fn(
                t, cur, self.owned_state(t), wr)
        return tw

    def exchange(self, tw):
        """Every non-owned window pixel refreshed from its owner, in place
        (after the owned regions are updated)."""
        for cp in self.copies:
            d = cp.dst
            tw[cp.dst_t, :, d[0]:d[1], d[2]:d[3]] = copy_piece(tw[cp.src_t],
                                                              cp)
        return tw


def copy_piece(window, cp: Copy):
    """cp's source rect of one window (b, skip, skip, C), flipped as cp
    says."""
    s = cp.src
    piece = window[:, s[0]:s[1], s[2]:s[3]]
    dims = [d for d, f in ((1, cp.flip_r), (2, cp.flip_c)) if f]
    return torch.flip(piece, dims) if dims else piece


def _piece_numel(cp: Copy, b: int, C: int) -> int:
    return b * (cp.src[1] - cp.src[0]) * (cp.src[3] - cp.src[2]) * C


class ResidentSampler:
    """The tile-resident ancestral (DDPM) reverse process of one rank.

    Tiles are chunked device-major: with tile_chunk tiles a UNet call in
    the JAX package, tile t sits on device t // n_chunks, and
    over `world` ranks each rank holds tile_chunk / world devices, so it
    holds the tiles [rank * per_rank, (rank + 1) * per_rank). The tile count
    is padded to a multiple of tile_chunk with dummy tiles that repeat the
    last window; their network output would be discarded, so they are never
    evaluated and never refreshed; a rank may hold dummies only (fewer tiles
    than ranks hold), and then only joins the collectives. With
    distributed=False one process holds every tile; under a process group
    the collectives run even on a group of one rank.
    """

    def __init__(self, denoiser, h: int, w: int, b: int, skip: int = 1024,
                 padding: int = 64, tile_chunk: int = 1,
                 distributed: bool = False, out_channels: int = 3):
        self.denoiser = denoiser
        self.plan = plan = ResidentPlan(h, w, skip, padding)
        self.b, self.C = b, out_channels
        self.tile_chunk = tile_chunk
        t_pad = plan.n_tiles + (-plan.n_tiles) % tile_chunk
        self.n_chunks = t_pad // tile_chunk
        self.grouped = distributed and dist.is_initialized()
        if self.grouped:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        if tile_chunk % self.world:
            raise ValueError('tile_chunk %d does not split over %d ranks'
                             % (tile_chunk, self.world))
        self.per_rank = t_pad // self.world
        lo = self.rank * self.per_rank
        self.mine = range(lo, lo + self.per_rank)
        # this rank's UNet calls: chunk j holds tile d * n_chunks + j of
        # each of its devices d
        devs = range(self.rank * (tile_chunk // self.world),
                     (self.rank + 1) * (tile_chunk // self.world))
        self.chunks = [[t for t in (d * self.n_chunks + j for d in devs)
                        if t < plan.n_tiles] for j in range(self.n_chunks)]
        self.chunks = [c for c in self.chunks if c]
        self._plan_exchange()

    def rank_of(self, t: int) -> int:
        return t // self.per_rank

    def _local(self, t: int) -> int:
        return t - self.mine.start

    def _plan_exchange(self):
        """This rank's owned tiles, its local copies, and per peer the copies
        it sends (source here) and receives (destination here), each list
        in the plan's order."""
        plan, me = self.plan, self.rank
        self.upd = [t for t in plan.owned if self.rank_of(t) == me]
        self.local, self.send, self.recv = [], {}, {}
        for cp in plan.copies:
            s, d = self.rank_of(cp.src_t), self.rank_of(cp.dst_t)
            if s == me and d == me:
                self.local.append(cp)
            elif s == me:
                self.send.setdefault(d, []).append(cp)
            elif d == me:
                self.recv.setdefault(s, []).append(cp)

    # -- conditioning, computed once per image --------------------------------
    def prepare(self, x_cond_net, guide_net):
        """The padded condition and this rank's hoisted guide maps per UNet
        call (the guide does not change over the reverse process)."""
        s = self.plan.skip
        if self.grouped:
            self._agree(x_cond_net)
        self.xc_pad = self.plan.canvas(x_cond_net)
        g_pad = self.plan.canvas(guide_net)
        self.maps = [compute_guide_maps(self.denoiser, torch.cat(
            [g_pad[:, hs:hs + s, ws:ws + s]
             for hs, ws in (self.plan.starts[t] for t in c)], dim=0))
            for c in self.chunks]

    def _agree(self, like):
        """Raises on every rank unless all ranks build this geometry: a rank
        called with other arguments would leave its peers waiting in the
        exchange. Also every rank's first collective here, so that all join
        the group before an exchange that pairs only some of them."""
        plan = self.plan
        v = torch.tensor([plan.h, plan.w, self.b, self.C, plan.skip,
                          plan.padding, self.tile_chunk],
                         dtype=torch.int64)
        both = torch.cat([v, -v]).to(_backend_device(like))
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        if not torch.equal(both[:len(v)], -both[len(v):]):
            raise ValueError('the ranks differ in (h, w, b, C, skip, padding, '
                             'tile_chunk): rank %d has %s'
                             % (self.rank, v.tolist()))

    def init_windows(self, img):
        """This rank's windows (per_rank, b, skip, skip, C) of the state
        `img`, the dummies repeating the last window (the image's last tile
        on a rank that holds dummies only)."""
        real = [t for t in self.mine if t < self.plan.n_tiles]
        tw = self.plan.extract(img, real or [self.plan.n_tiles - 1])
        if len(tw) < self.per_rank:
            tw = torch.cat([tw, tw[-1:].expand(
                (self.per_rank - len(tw),) + tuple(tw.shape[1:]))])
        return tw.contiguous()

    # -- one step ---------------------------------------------------------
    def _slots(self, c):
        """Chunk c's local window slots as a slice (its tiles are n_chunks
        apart): basic indexing, so no index tensor goes to the card, and no
        copy from pageable host memory waits for the stream."""
        i = self._local(c[0])
        return slice(i, i + len(c) * self.n_chunks, self.n_chunks)

    def eps(self, tw, noise_level, net_dtype):
        """The UNet's eps on this rank's real windows, in tw's dtype (dummy
        slots left empty)."""
        s, b = self.plan.skip, self.b
        out = torch.empty_like(tw)
        for c, m in zip(self.chunks, self.maps):
            sl = self._slots(c)
            xc = torch.cat([self.xc_pad[:, hs:hs + s, ws:ws + s]
                            for hs, ws in (self.plan.starts[t] for t in c)])
            im = tw[sl].reshape((len(c) * b,) + tuple(tw.shape[2:]))
            net = torch.cat([xc, im.to(net_dtype)], dim=-1)
            nl = noise_level[:1].expand(net.shape[0], noise_level.shape[1])
            e = self.denoiser.naiveforward(net, nl, net[..., :3],
                                           guide_maps=m)
            out[sl] = e.to(tw.dtype).reshape((len(c), b) + e.shape[1:])
        return out

    def update(self, tw, eps, z, coefs, clip_denoised: bool = True):
        """The ancestral update on this rank's owned rects, in place, with
        p_sample_loop's arithmetic (diffusion/sampler.py). z: the whole
        state's draw (zeros at t = 0)."""
        sra, srm1, c1, c2, sigma = coefs
        for t in self.upd:
            r0, r1, q0, q1 = self.plan.owned_window(t)
            s0, s1, s2, s3 = self.plan.owned_state(t)
            lt = self._local(t)
            cur = tw[lt, :, r0:r1, q0:q1]
            x0 = sra * cur - srm1 * eps[lt, :, r0:r1, q0:q1]
            if clip_denoised:
                x0 = x0.clamp(-1., 1.)
            mean = c1 * x0 + c2 * cur
            tw[lt, :, r0:r1, q0:q1] = mean + z[:, s0:s1, s2:s3] * sigma

    def exchange(self, tw):
        """Refreshes every non-owned pixel of this rank's windows: the copies
        within the rank in place, the others from their owners' ranks, one
        packed buffer per peer through batch_isend_irecv."""
        for cp in self.local:
            d = cp.dst
            tw[self._local(cp.dst_t), :, d[0]:d[1], d[2]:d[3]] = copy_piece(
                tw[self._local(cp.src_t)], cp)
        if not self.send and not self.recv:
            return
        b, C = self.b, self.C
        dev = _backend_device(tw)
        ops, inbox = [], {}
        # every rank lists its peers in ascending order, a send before a
        # receive, so the lists pair up
        for peer in sorted(set(self.send) | set(self.recv)):
            if peer in self.send:
                buf = torch.cat([copy_piece(tw[self._local(cp.src_t)], cp)
                                 .reshape(-1) for cp in self.send[peer]])
                ops.append(dist.P2POp(dist.isend, buf.to(dev), peer))
            if peer in self.recv:
                n = sum(_piece_numel(cp, b, C) for cp in self.recv[peer])
                inbox[peer] = torch.empty(n, dtype=tw.dtype, device=dev)
                ops.append(dist.P2POp(dist.irecv, inbox[peer], peer))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for peer, buf in inbox.items():
            buf, pos = buf.to(tw.device), 0
            for cp in self.recv[peer]:
                d, n = cp.dst, _piece_numel(cp, b, C)
                tw[self._local(cp.dst_t), :, d[0]:d[1], d[2]:d[3]] = \
                    buf[pos:pos + n].view(b, d[1] - d[0], d[3] - d[2], C)
                pos += n

    # -- the end: one gather --------------------------------------------------
    def materialize(self, frames: Sequence[torch.Tensor]):
        """Each of `frames` (this rank's windows at some step) -> the state
        (b, h, w, C), on every rank: the owned regions of all ranks gathered
        once, in one buffer, for all frames."""
        plan, b, C = self.plan, self.b, self.C
        ref = frames[0]
        outs = [ref.new_zeros((b, plan.h, plan.w, C)) for _ in frames]

        def place(out, t, piece):
            s0, s1, s2, s3 = plan.owned_state(t)
            out[:, s0:s1, s2:s3] = piece

        if not self.grouped:
            for out, tw in zip(outs, frames):
                for t in self.upd:
                    r0, r1, q0, q1 = plan.owned_window(t)
                    place(out, t, tw[self._local(t), :, r0:r1, q0:q1])
            return outs

        def numel(t):
            s0, s1, s2, s3 = plan.owned_state(t)
            return b * (s1 - s0) * (s3 - s2) * C

        owners = [[t for t in plan.owned if self.rank_of(t) == r]
                  for r in range(self.world)]
        sizes = [len(frames) * sum(numel(t) for t in o) for o in owners]
        n = max(sizes)
        dev = _backend_device(ref)
        parts = [tw[self._local(t), :, r0:r1, q0:q1].reshape(-1)
                 for tw in frames for t in self.upd
                 for r0, r1, q0, q1 in (plan.owned_window(t),)]
        mine = torch.cat(parts) if parts else ref.new_zeros(0)
        send = torch.zeros(n, dtype=ref.dtype, device=dev)
        send[:mine.numel()] = mine.to(dev)
        got = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(got, send)
        for r, buf in enumerate(got):
            buf, pos = buf.to(ref.device), 0
            for out in outs:
                for t in owners[r]:
                    s0, s1, s2, s3 = plan.owned_state(t)
                    k = numel(t)
                    place(out, t, buf[pos:pos + k].view(b, s1 - s0, s3 - s2,
                                                        C))
                    pos += k
        return outs


def resident_reverse(denoiser, sched, x_cond, x_cond_net, guide_net,
                     noise: Callable, continous: bool = False,
                     skip: int = 1024, padding: int = 64,
                     tile_chunk: int = 1, distributed: bool = False,
                     clip_denoised: bool = True):
    """The whole tile-resident ancestral reverse loop: a drop-in for
    p_sample_loop over parallel/tiled.tiled_denoise_fn (diffusion/
    sampler.py), with the same draws from `noise` (the initial state, then
    one whole-state draw a step, the t = 0 one multiplied by 0) and the same
    snapshot cadence. x_cond: the float32 sampler-state condition (its shape
    the state's); x_cond_net, guide_net: the networks' condition and guide
    in their dtype. distributed: the tiles over the ranks of the process
    group (every rank must call this with the same arguments and draws).
    Returns the image, or (image, snapshots) when continous; on every
    rank."""
    from ucdir_tpu_torch.diffusion.sampler import _snapshot_slots

    b, h, w, C = x_cond.shape
    rs = ResidentSampler(denoiser, h, w, b, skip=skip, padding=padding,
                         tile_chunk=tile_chunk, distributed=distributed,
                         out_channels=C)
    rs.prepare(x_cond_net, guide_net)
    net_dtype = x_cond_net.dtype
    T = sched.num_timesteps
    tw = rs.init_windows(noise(tuple(x_cond.shape)))
    slots, n_snap = _snapshot_slots(T)
    snaps = [None] * n_snap if continous else None
    for i, t in enumerate(range(T - 1, -1, -1)):
        noise_level = sched.sqrt_alphas_cumprod_prev[t + 1].expand(b, 1)
        eps = rs.eps(tw, noise_level.to(net_dtype), net_dtype)
        z = noise(tuple(x_cond.shape))
        if t == 0:
            z = torch.zeros_like(z)
        coefs = (sched.sqrt_recip_alphas_cumprod[t],
                 sched.sqrt_recipm1_alphas_cumprod[t],
                 sched.posterior_mean_coef1[t], sched.posterior_mean_coef2[t],
                 torch.exp(0.5 * sched.posterior_log_variance_clipped[t]))
        rs.update(tw, eps, z, coefs, clip_denoised)
        del eps
        rs.exchange(tw)
        # a slot keeps the image of the last step that writes it
        if snaps is not None and (i + 1 == T or slots[i + 1] != slots[i]):
            snaps[int(slots[i])] = tw.clone()
    frames = rs.materialize([tw] + (snaps or []))
    if continous:
        return frames[0], torch.cat([x_cond[None], torch.stack(frames[1:])],
                                    dim=0)
    return frames[0]
