#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ucdir_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, all run in this order, each printing one line (or a few) and raising
on any failure:
  1. build    nvcc builds csrc/*.cu for sm_90a; prints the build seconds,
              each kernel's registers and spills, the card and its power
              limit.
  2. kernels  K1..K4 and K7..K9 at the SID validation path's shapes (one
              1568 x 2272 frame; K7 also at one 1024 x 1024 tile) and the
              backward kernels K5 and K6 at the SID train
              path's shapes (288 x 288 and its levels, at batch 8: the plain
              side of K5 materializes the 8x candidate tensor several times,
              which at batch 32 crowds the card's memory) against their plain
              PyTorch versions on the card (TF32 off): max abs error, kernel,
              plain and library-call milliseconds (CUDA events), and the
              bound: the larger of counted bytes over 3.35 TB/s and counted
              FLOP over 67 TFLOP/s (fp32 outside the tensor cores: every
              kernel's product is fp32 FMA). K2 and K3 also at the shapes
              that pick their other tiles: the 64 -> 3 `final` conv (8-wide
              tile) and the 1024 -> 512 convs of the /8 level (128-wide
              tile), K1 and K8 at C = 8, 16 and 32 (the narrow tiles) on
              the frame's /8 level, and K5 at C = 32 (288 x 288) and 192 (36 x
              36), widths of narrower models. K1, K5 and K6 run twice: K1's
              statistics, K5's and K6's weight and bias gradients (and K5's
              attention gradients) must be equal bit for bit; K6's library
              time in the swish cases includes the F.conv2d that recomputes
              z. Then the bf16 forms of K1, K2, K3, K4 and K7 at the
              validation shapes against their bf16 plain versions: outputs
              within one bf16 ulp of max(1, largest), 2^-7 of it (both
              round at the same places; a float32 sum in another order can
              flip an output's last bit), statistics within 1e-4 of the
              largest sum of squares; the library is the same PyTorch call
              in bf16 (cuDNN, cuBLAS), the bound the larger of the counted
              bytes at 2 a value and the counted FLOP at 989 TFLOP/s (bf16
              on the tensor cores, dense), with the fp32 FMA product's issue
              time at 67 TFLOP/s printed beside it (K1's, K2's, K3's, K5's,
              K6's and K7's bf16 forms run on the tensor cores,
              csrc/igemm_tc.cuh; K1's and K2's bf16 statistics and K4's
              bf16 sums, added in a fixed order, must be equal bit for bit
              in a second call); K1 in bf16 also at C = 8, 16, 24, 32 and
              192 on the frame's /8 level (its groups merged below 8
              channels, and the inner_channel 24 model's widths); the
              edges of that core
              in bf16 (ragged last tiles at 195 x 283, cout 24 and 96, cin 6
              and 96, stride 2 at 391 x 567, K3 at 1568 x 2271 with cin 96,
              6 and cout 3, K7 at cout 24 and 96); and the bf16 forms of K5
              and K6 at the train shapes of
              their fp32 cases, held alike (their dW, dbias and K5's
              attention gradients bit-identical in a second call), the
              library `aten.convolution_backward` in bf16; they too run on
              the tensor cores.
  3. slice    the full-width SID model (random weights from --seed) restores
              a 96 x 96 input with 2 steps and injected noise on the card and
              on the host (plain versions); the outputs must agree.
  4. main     Trainer.test, 50 steps, full width, on a 96 x 96 pair made from
              --seed: time, PSNR (SSIM needs cv2, which this script does not
              assume), peak memory; every kernel's launch count must rise.
  5. sid      one 1424 x 2128 frame (1568 x 2272 in the network) restored
              through the validation step with 10 DDPM steps: seconds for the
              frame, predictor + guide maps ms, ms per DY3h step, peak
              memory, launches.
  5b. bf16    validation with --compute_dtype bf16 (the bf16 kernels): the
              slice of phase 3 in bf16, card against host, mean abs within
              1e-3 and the max printed, and the same for the `dropout: 0`
              model (K7 in bf16); phase 4's Trainer.test in bf16 (every
              bf16 kernel of the frame launched); then phase 5's frame in
              bf16 (its draws
              and generator): seconds, ms per DY3h step, peak memory,
              launches, every bf16 kernel launched, and its distance from
              phase 5's float32 frame, mean abs within 0.05 (the JAX
              package's test of bf16 against fp32); every launch of K1, K2,
              K3 and K7 in bf16 there and on the `dropout: 0` slice must
              have gone through the tensor-core core, and no other launch,
              of the bf16 or the float32 frame.
  6. train_slice  full width, crop 64, batch 2, dropout off, injected gammas
              and noise, 2 AdamW steps on the card and on the host: the loss
              of each step, every gradient of the first step and every
              parameter after the second must agree; then the same for the
              model with inner_channel 24 (C = 24, 48, 96, 192: K1's and
              K5's narrow and 64-column tiles on the train path); then the
              SID model in bf16 on float32 masters (--compute_dtype bf16):
              each loss within 1e-3 rel, the parameters within 2 * lr a
              step, the gradients' distance printed, only the bf16 kernels
              launched on the card, masters, gradients and AdamW state
              float32.
  7. train    the Trainer in its train phase at full width: crop 256 (288 x
              288 in the network), batch 32 (halved while it does not fit),
              8 optimize_parameters on one seeded batch with dropout on:
              seconds per step, losses (finite, the last below the first),
              peak memory, launches of K1..K6; then save_network, a reload
              of the EMA weights by a validation Trainer and one test on a
              96 x 96 input.
  7b. train_bf16  the same steps with --compute_dtype bf16 (5, the first a
              warm-up): seconds per step, peak memory, only the bf16 forms
              of K1..K6 launched, every call of K1, K2, K3, K5 and K6 in
              bf16 through the tensor-core core, masters, gradients, AdamW
              state, EMA and the saved weights float32.
  8. variants the full-width model with `dropout: 0` (folded head, K7) and
              each AKGM tail ('fused' K1, 'mix' K8, 'packed' K9) restores a
              256 x 256 input with 2 DDPM steps and injected noise on the
              card and on the host: card and host agree for every tail,
              'mix' equals 'fused' on the card, and the launch counts are
              those of the tail.
  9. fewstep  the 1424 x 2128 frame through the validation step of the
              `dropout: 0` model with ddim (5 steps), dpmpp (20) and
              dpmpp_sde (20), in float32 and then in bf16: seconds per
              frame, ms per step, PSNR against a generated target, the
              launches of K1 and K7 (or their bf16 forms); and ddim, 3
              steps, 64 x 64, card against host.
 10. hires    one 2848 x 4256 frame (the full-resolution Sony frame; 2976 x
              4384 after the pad, so it runs tiled: 24 tiles of 1024 x 1024
              per step) with ddim, 5 steps: seconds per frame and per step,
              tiles per step, peak memory, K7 launches; the same frame in
              bf16 with 2 steps, its peak below the float32 frame's; and the
              tiled path ({skip: 128, padding: 16}, 200 x 260 input, 2 DDPM
              steps) card against host.
Then one JSON line of kernel results (each kernel's launches from the path
that owns it: K1..K4 the main phase, K5 and K6 the train phase, K7 the
fewstep phase, K8 and K9 their variants run, the bf16 forms the bf16 frame,
K7's the bf16 `dropout: 0` slice and K5's and K6's the bf16 train steps;
every path's counts beside them, and `tc_launches`, of a kernel's launches
on its path those that went through the tensor-core core (None where the
path's were not read);
errors the largest and times summed over phase 2's shapes), the card's
`nvidia-smi` name and power limit, and last `{"ok": true, "device": {...}}`.

Needs torch, numpy and the repository beside this file, and imports nothing
of JAX or of the JAX package; exits non-zero, with no result line, when CUDA
is unavailable or the port is absent.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SID_FRAME = (1424, 2128)          # a Sony SID test frame, H x W
PAD = 64                          # the validation reflect pad
NET_FRAME = (1568, 2272)          # SID_FRAME + 2 * PAD, to /32 in DY3h
FULL_FRAME = (2848, 4256)         # a full-resolution Sony SID frame
TILE = 1024                       # the tiled path's tile, with 64-px halos
SID_STEPS = 10                    # DDPM steps of the sid phase
BLOCKS = 27                       # AKGM blocks of the SID denoiser
TRAIN_CROP = 256                  # the SID train crop
TRAIN_NET = (TRAIN_CROP // 32 + 1) * 32   # 288: as DY3h pads the crop
TRAIN_BATCH = 32                  # the SID train batch
TRAIN_STEPS = 8
BF16_TRAIN_STEPS = 5              # bf16 train steps, the first a warm-up
KERNEL_BATCH = 8                  # batch of K5's and K6's phase-2 cases
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
FP32_FLOP_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12          # H100 SXM bf16 on the tensor cores, dense

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    'akgm_tail': ('ucdir_tpu_torch/csrc/akgm_tail.cu',
                  'ucdir_tpu/ops/akgm_pallas.py:495'),
    'conv3x3': ('ucdir_tpu_torch/csrc/conv3x3.cu',
                'ucdir_tpu/ops/conv_pallas.py:175'),
    'conv1x1': ('ucdir_tpu_torch/csrc/conv1x1.cu',
                'ucdir_tpu/ops/conv_pallas.py:688'),
    'gn1_stats': ('ucdir_tpu_torch/csrc/gn1_stats.cu',
                  'ucdir_tpu/ops/stats_pallas.py:38'),
    'akgm_tail_bwd': ('ucdir_tpu_torch/csrc/akgm_tail_bwd.cu',
                      'ucdir_tpu/ops/akgm_pallas.py:722'),
    'conv3x3_bwd': ('ucdir_tpu_torch/csrc/conv3x3_bwd.cu',
                    'ucdir_tpu/ops/conv_pallas.py:516'),
    'conv3x3_preact': ('ucdir_tpu_torch/csrc/conv3x3.cu',
                       'ucdir_tpu/ops/conv_pallas.py:796'),
    'akgm_mix': ('ucdir_tpu_torch/csrc/akgm_tail.cu',
                 'ucdir_tpu/ops/akgm_pallas.py:83'),
    'akgm_packed': ('ucdir_tpu_torch/csrc/akgm_packed.cu',
                    'ucdir_tpu/ops/akgm_pallas.py:1012'),
}
# the bf16 forms: the same sources, the TPU kernels' bf16 instantiation
BF16 = ('akgm_tail', 'conv3x3', 'conv1x1', 'gn1_stats', 'conv3x3_preact',
        'akgm_tail_bwd', 'conv3x3_bwd')
KERNELS.update({k + '_bf16': KERNELS[k] for k in BF16})
# the path whose run gives a kernel's `launches`
OWNER = {'akgm_tail': 'main', 'conv3x3': 'main', 'conv1x1': 'main',
         'gn1_stats': 'main', 'akgm_tail_bwd': 'train',
         'conv3x3_bwd': 'train', 'conv3x3_preact': 'fewstep',
         'akgm_mix': 'variants_mix', 'akgm_packed': 'variants_packed',
         'akgm_tail_bf16': 'bf16', 'conv3x3_bf16': 'bf16',
         'conv1x1_bf16': 'bf16', 'gn1_stats_bf16': 'bf16',
         'conv3x3_preact_bf16': 'bf16_head',
         'akgm_tail_bwd_bf16': 'train_bf16', 'conv3x3_bwd_bf16': 'train_bf16'}


# per path, the launches of each entry point that went through the
# tensor-core core (csrc/igemm_tc.cuh), read where the path's launches are
TC = {}


def say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_build():
    from ucdir_tpu_torch.ops import _build
    t = time.perf_counter()
    so = _build.build()
    _build.library()
    secs = time.perf_counter() - t
    say('build', 'built %s in %.2f s' % (os.path.relpath(so, ROOT), secs))
    log = so.with_suffix('.log')
    if log.is_file():
        for line in log.read_text().splitlines():
            if 'Compiling entry function' in line:
                say('build', 'ptxas: ' + line.split("'")[1])
            elif 'Used' in line or 'spill' in line:
                say('build', 'ptxas:     ' + line.strip())


# ---------------------------------------------------------------- phase 2
def timed(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_cases(gen, dev):
    """One dict per case: the kernel's name, a label, the kernel call, the
    plain call, the library call (one PyTorch call computing the same
    function, or None), the FLOP and the bytes the function needs (each input
    read once, each output written once), the peak rate of its operands' type
    and how many trailing outputs are (B, C) statistics. K1..K4 at the SID
    validation shapes (the padded frame 1568 x 2272 and its /2, /4, /8
    levels); K5 and K6 at the SID train shapes (288 x 288 and its levels) at
    batch KERNEL_BATCH; then, from the same builders on operands rounded to
    bf16, the bf16 forms of K1, K2, K3, K4 and K7 at the validation shapes."""
    import torch
    import torch.nn.functional as F
    from ucdir_tpu_torch.ops import akgm, conv, stats

    H0, W0 = NET_FRAME
    G, f32 = 8, torch.float32

    def rnd(*shape, scale=1.0, off=0.0, gen=gen, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + off).to(dtype)

    def nbytes(*tensors):
        return sum(t.element_size() * t.numel() for t in tensors
                   if t is not None)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def kind(name, dtype):
        """A case's name, tolerance and peak rate (float32: phase_kernels'
        defaults) for its operands' type: a bf16 form's outputs within one
        bf16 ulp of max(1, largest), its statistics within 1e-4 of the
        largest sum of squares."""
        if dtype == f32:
            return dict(name=name)
        return dict(name=name + '_bf16', tol=(2. ** -7, 1e-4),
                    flop_per_s=BF16_FLOP_PER_S)

    cases = []

    def akgm_operands(B, H, W, C, gen=gen, dtype=f32):
        h = rnd(B, H, W, C, scale=0.5, gen=gen, dtype=dtype)
        att = rnd(B, H, W, G, scale=0.5, gen=gen, dtype=dtype)
        aw = rnd(B, G, scale=0.3, off=1.0, gen=gen, dtype=dtype)
        w = rnd(9 * C // G, C * G, scale=(9 * C / G) ** -0.5, gen=gen,
                dtype=dtype)
        b = rnd(C * G, scale=0.1, gen=gen, dtype=dtype)
        kw = dict(norm_scale=rnd(B, C, scale=0.2, off=1.0, gen=gen,
                                 dtype=dtype),
                  norm_shift=rnd(B, C, scale=0.2, gen=gen, dtype=dtype),
                  attw=aw)
        # the grouped conv, then the 8-candidate mix per channel
        flop = B * H * W * C * G * (2 * 9 * C // G + 2)
        return h, att, w, b, kw, flop

    def k1_case(C, H, W, gen=gen, dtype=f32):
        """K1 with fold, attw and statistics; returns its operands."""
        h, att, w, b, kw, flop = akgm_operands(1, H, W, C, gen=gen,
                                               dtype=dtype)
        res = rnd(1, H, W, C, scale=0.5, gen=gen, dtype=dtype)
        cases.append(dict(
            **kind('akgm_tail', dtype),
            label='C=%d %dx%d fold+attw+stats' % (C, H, W),
            kernel=lambda: akgm.akgm_block_tail(h, att, w, b, res, G,
                                                emit_stats=True, **kw),
            plain=lambda: akgm.akgm_block_tail_plain(h, att, w, b, res, G,
                                                     emit_stats=True, **kw),
            library=None, stats=2, fixed=(1, 2), flop=flop,
            bits=None if dtype == f32 else 0.99,
            bytes=nbytes(h, att, w, b, res, h, *kw.values()) + 8 * C))
        return h, att, w, b, res, kw, flop

    levels = ((64, 1), (128, 2), (256, 4), (512, 8))
    for C, s in levels:
        H, W = H0 // s, W0 // s
        h, att, w, b, res, kw, flop = k1_case(C, H, W)
        cases.append(dict(
            name='akgm_mix', label='C=%d %dx%d' % (C, H, W),
            kernel=lambda h=h, att=att, w=w, b=b:
                akgm.akgm_mix(h, att, w, b, G),
            plain=lambda h=h, att=att, w=w, b=b:
                akgm.akgm_mix_reference(h, att, w, b, G),
            library=None, stats=0, flop=flop, bytes=nbytes(h, att, w, b, h)))
        wp = akgm.pack_grouped_weight(w, G).contiguous()
        # the dense 9C -> C product, then the attention-weighted bias
        cases.append(dict(
            name='akgm_packed', label='C=%d %dx%d fold+attw' % (C, H, W),
            kernel=lambda h=h, att=att, wp=wp, b=b, res=res, kw=kw:
                akgm.akgm_block_tail_packed(h, att, wp, b, res, G, **kw),
            plain=lambda h=h, att=att, wp=wp, b=b, res=res, kw=kw:
                akgm.akgm_block_tail_packed_plain(h, att, wp, b, res, G,
                                                  **kw),
            library=None, stats=0, flop=H * W * C * (2 * 9 * C + 2 * G),
            bytes=nbytes(h, att, wp, b, res, h, *kw.values())))

    # K1 and K8 at the widths of narrower models (the tiles of 128 pixels by
    # 8, 16 and 32 columns) on the frame's /8 level, from a generator of
    # their own like K7's
    gen_narrow = torch.Generator(dev).manual_seed(gen.initial_seed() + 8)
    for C in (8, 16, 32):
        H, W = H0 // 8, W0 // 8
        h, att, w, b, res, kw, flop = k1_case(C, H, W, gen=gen_narrow)
        cases.append(dict(
            name='akgm_mix', label='C=%d %dx%d' % (C, H, W),
            kernel=lambda h=h, att=att, w=w, b=b:
                akgm.akgm_mix(h, att, w, b, G),
            plain=lambda h=h, att=att, w=w, b=b:
                akgm.akgm_mix_reference(h, att, w, b, G),
            library=None, stats=0, flop=flop, bytes=nbytes(h, att, w, b, h)))

    def conv_case(label, B, H, W, cin, cout, stride=1, fold=False, act=None,
                  backward=False, gen=gen, dtype=f32, gen_go=gen):
        x = rnd(B, H, W, cin, scale=0.5, gen=gen, dtype=dtype)
        w = rnd(9 * cin, cout, scale=(9 * cin) ** -0.5, gen=gen, dtype=dtype)
        b = rnd(cout, scale=0.1, gen=gen, dtype=dtype)
        k = w.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        a = rnd(B, cin, scale=0.2, off=1.0, gen=gen, dtype=dtype) \
            if fold else None
        t = rnd(B, cin, scale=0.2, gen=gen, dtype=dtype) if fold else None
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        flop = 2 * 9 * cin * cout * B * Ho * Wo
        n_out = B * Ho * Wo * cout
        if not backward:
            kw = dict(stride=stride, act=act, emit_stats=True, norm_scale=a,
                      norm_shift=t)
            # bf16: statistics added in a fixed order, the same bits again
            cases.append(dict(
                **kind('conv3x3', dtype), label=label,
                kernel=lambda: conv.conv3x3(x, w, b, **kw),
                plain=lambda: conv.conv3x3_plain(x, w, b, **kw),
                library=lambda: F.conv2d(nchw(x), k, b, stride=stride,
                                         padding=1),
                stats=2, fixed=() if dtype == f32 else (1, 2), flop=flop,
                bytes=(nbytes(x, w, b, a, t) + x.element_size() * n_out
                       + 8 * B * cout)))
            return
        go = rnd(B, H, W, cout, gen=gen_go, dtype=dtype)
        kw = dict(act=act, norm_scale=a, norm_shift=t)

        def library():
            # the input and the weight gradient, and z again where swish
            # needs it
            out = torch.ops.aten.convolution_backward(
                nchw(go), nchw(x), k, [cout], [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [True, True, True])
            return (out, F.conv2d(nchw(x), k, b, padding=1)) if act else out
        cases.append(dict(
            **kind('conv3x3_bwd', dtype), label=label,
            kernel=lambda: conv.conv3x3_backward_kernel(x, w, b, go, act, a,
                                                        t),
            plain=lambda: conv.conv3x3_backward_plain(x, w, b, go, **kw),
            library=library, stats=0, fixed=(1, 2),
            flop=flop * (3 if act else 2),
            bytes=nbytes(x, go, w, b, a, t, x, w, b)))

    # K2's validation shapes: (label, H, W, cin, cout, options)
    h2, w2, h8, w8 = H0 // 2, W0 // 2, H0 // 8, W0 // 8
    val_convs = (
        ('downs_0 6->64 %dx%d stats' % (H0, W0), H0, W0, 6, 64, {}),
        ('conv1 192->64 %dx%d fold+swish+stats' % (H0, W0), H0, W0, 192, 64,
         dict(fold=True, act='swish')),
        ('downsample 64->64 stride 2 %dx%d stats' % (H0, W0), H0, W0, 64, 64,
         dict(stride=2)),
        ('upsample 128->4x128 packed %dx%d stats' % (h2, w2), h2, w2, 128,
         512, {}),
        ('final 64->3 %dx%d stats' % (H0, W0), H0, W0, 64, 3, {}),
        ('conv1 1024->512 %dx%d fold+swish+stats' % (h8, w8), h8, w8, 1024,
         512, dict(fold=True, act='swish')))
    for label, H, W, cin, cout, opts in val_convs[:4]:
        conv_case(label, 1, H, W, cin, cout, **opts)

    # K7's operands come from a generator of their own, so the cases after
    # them draw what they drew before K7 was added
    gen7 = torch.Generator(dev).manual_seed(gen.initial_seed() + 7)

    def preact_case(H, W, cin=64, cout=3, gen=gen7, dtype=f32):
        x = rnd(1, H, W, cin, scale=0.5, gen=gen, dtype=dtype)
        w = rnd(9 * cin, cout, scale=(9 * cin) ** -0.5, gen=gen, dtype=dtype)
        b = rnd(cout, scale=0.1, gen=gen, dtype=dtype)
        k = w.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        a = rnd(1, cin, scale=0.2, off=1.0, gen=gen, dtype=dtype)
        t = rnd(1, cin, scale=0.2, gen=gen, dtype=dtype)
        xa = conv.swish(x * a[:, None, None, :] + t[:, None, None, :])
        # library: the convolution alone, on an input activated beforehand:
        # it leaves the affine and the swish out
        cases.append(dict(
            **kind('conv3x3_preact', dtype),
            label='head %d->%d %dx%d fold' % (cin, cout, H, W),
            kernel=lambda: conv.conv3x3_preact(x, w, b, a, t),
            plain=lambda: conv.conv3x3_preact_plain(x, w, b, a, t),
            library=lambda: F.conv2d(nchw(xa), k, b, padding=1),
            stats=0, flop=2 * 9 * cin * cout * H * W,
            bytes=nbytes(x, w, b, a, t) + x.element_size() * cout * H * W))

    preact_case(H0, W0)
    preact_case(TILE, TILE)

    def conv1x1_case(H, W, cin, cout, gen=gen, dtype=f32):
        x = rnd(1, H, W, cin, scale=0.5, gen=gen, dtype=dtype)
        w1 = rnd(cin, cout, scale=cin ** -0.5, gen=gen, dtype=dtype)
        b1 = rnd(cout, scale=0.1, gen=gen, dtype=dtype)
        cases.append(dict(
            **kind('conv1x1', dtype),
            label='res_conv %d->%d %dx%d' % (cin, cout, H, W),
            kernel=lambda: conv.conv1x1(x, w1, b1),
            plain=lambda: conv.conv1x1_plain(x, w1, b1),
            library=lambda: torch.addmm(b1, x.reshape(-1, cin), w1),
            stats=0, flop=2 * cin * cout * H * W,
            bytes=nbytes(x, w1, b1) + x.element_size() * cout * H * W))

    conv1x1_case(H0, W0, 192, 64)
    # the shapes that pick K2's and K3's other tiles, from a generator of
    # their own like K7's
    gen_tiles = torch.Generator(dev).manual_seed(gen.initial_seed() + 4)
    for label, H, W, cin, cout, opts in val_convs[4:]:
        conv_case(label, 1, H, W, cin, cout, gen=gen_tiles, **opts)
    conv1x1_case(h8, w8, 1024, 512, gen=gen_tiles)

    def k4_case(gen=gen, dtype=f32):
        xs = rnd(1, h8, w8, 1024, gen=gen, dtype=dtype)
        # bf16: added per slab of pixels in a fixed order, the same bits
        # again
        cases.append(dict(
            **kind('gn1_stats', dtype), label='C=1024 %dx%d' % (h8, w8),
            kernel=lambda: stats.gn1_stats(xs),
            plain=lambda: stats.gn1_stats_plain(xs),
            library=None, stats=2, fixed=() if dtype == f32 else (0, 1),
            flop=3 * xs.numel(), bytes=nbytes(xs) + 8 * 1024))

    k4_case()

    # the backward kernels at the train path's shapes
    B, T = KERNEL_BATCH, TRAIN_NET

    def k5_case(C, H, gen=gen, dtype=f32):
        h, att, w, b, kw, flop = akgm_operands(B, H, H, C, gen=gen,
                                               dtype=dtype)
        go = rnd(B, H, H, C, gen=gen, dtype=dtype)
        cases.append(dict(
            **kind('akgm_tail_bwd', dtype),
            label='B=%d C=%d %dx%d fold+attw' % (B, C, H, H),
            kernel=lambda: akgm.akgm_block_tail_backward_kernel(
                h, att, w, b, go, G, kw['norm_scale'], kw['norm_shift'],
                kw['attw']),
            plain=lambda: akgm.akgm_block_tail_backward_plain(
                h, att, w, b, go, G, **kw),
            library=None, stats=0, fixed=(1, 2, 3, 4), flop=3 * flop,
            bytes=nbytes(h, go, att, w, b, *kw.values(), h, att, w, b,
                         kw['attw'])))

    k5_levels = ((64, 1), (128, 2), (256, 4), (512, 8), (512, 16))
    for C, s in k5_levels:
        k5_case(C, T // s)
    # K5 at the widths of narrower models: C = 32 on the narrow tiles (inner
    # channel 32, level 0) and C = 192 on 256 x 64 (inner channel 24, /8),
    # from a generator of their own like K7's
    gen_k5 = torch.Generator(dev).manual_seed(gen.initial_seed() + 5)
    k5_case(32, T, gen=gen_k5)
    k5_case(192, T // 8, gen=gen_k5)
    # K6's train shapes: (label, H, cin, cout, options)
    k6_shapes = (
        ('B=%d downs_0 6->64 %dx%d' % (B, T, T), T, 6, 64, {}),
        ('B=%d conv1 192->64 %dx%d fold+swish' % (B, T, T), T, 192, 64,
         dict(fold=True, act='swish')),
        ('B=%d conv1 384->128 %dx%d fold+swish' % (B, T // 2, T // 2),
         T // 2, 384, 128, dict(fold=True, act='swish')),
        ('B=%d conv1 1024->512 %dx%d fold+swish' % (B, T // 8, T // 8),
         T // 8, 1024, 512, dict(fold=True, act='swish')),
        ('B=%d upsample 128->4x128 packed %dx%d' % (B, T // 2, T // 2),
         T // 2, 128, 512, {}),
        ('B=%d final 64->3 %dx%d' % (B, T, T), T, 64, 3, {}))
    for label, H, cin, cout, opts in k6_shapes:
        conv_case(label, B, H, H, cin, cout, backward=True, **opts)

    # the bf16 forms at the validation shapes, from a generator of their own
    g16, bf = (torch.Generator(dev).manual_seed(gen.initial_seed() + 16),
               torch.bfloat16)
    for C, s in levels:
        k1_case(C, H0 // s, W0 // s, gen=g16, dtype=bf)
    # K1 in bf16 at the narrow widths (groups below 8 channels merged on the
    # tensor cores) and the inner_channel 24 model's /8 width, on the
    # frame's /8 level, from a generator of their own
    g_k1 = torch.Generator(dev).manual_seed(gen.initial_seed() + 12)
    for C in (8, 16, 24, 32, 192):
        k1_case(C, h8, w8, gen=g_k1, dtype=bf)
    for label, H, W, cin, cout, opts in val_convs:
        conv_case(label, 1, H, W, cin, cout, gen=g16, dtype=bf, **opts)
    conv1x1_case(H0, W0, 192, 64, gen=g16, dtype=bf)
    conv1x1_case(h8, w8, 1024, 512, gen=g16, dtype=bf)
    k4_case(gen=g16, dtype=bf)
    preact_case(H0, W0, gen=g16, dtype=bf)
    preact_case(TILE, TILE, gen=g16, dtype=bf)
    # the edges of the tensor-core core (csrc/igemm_tc.cuh) in bf16, from a
    # generator of their own: ragged last pixel tiles (195 x 283: 25 x 18
    # tiles of 8 x 16 pixels, the last row and column short), TMA boxes of
    # weights past cout (24, 96), a
    # 64-channel chunk half used (96), cin = 6 (the scalar staging), stride
    # 2 at an odd size, the 8-column tile (cout = 3)
    g_edge = torch.Generator(dev).manual_seed(gen.initial_seed() + 10)
    he, we = h8 - 1, w8 - 1
    for label, H, W, cin, cout, opts in (
            ('edge ragged 64->64 %dx%d fold+swish+stats' % (he, we), he, we,
             64, 64, dict(fold=True, act='swish')),
            ('edge 64->24 %dx%d stats' % (he, we), he, we, 64, 24, {}),
            ('edge 96->96 %dx%d fold+stats' % (he, we), he, we, 96, 96,
             dict(fold=True)),
            ('edge 6->64 %dx%d stats' % (he, we), he, we, 6, 64, {}),
            ('edge stride 2 64->64 %dx%d stats' % (2 * he + 1, 2 * we + 1),
             2 * he + 1, 2 * we + 1, 64, 64, dict(stride=2))):
        conv_case(label, 1, H, W, cin, cout, gen=g_edge, dtype=bf, **opts)
    # K3's at the frame's size with an odd width (27819 tiles of 128 and 96
    # pixels): at 195 x 283 a 1x1 conv is as short as its launch
    for cin, cout in ((96, 24), (6, 64), (64, 3)):
        conv1x1_case(H0, W0 - 1, cin, cout, gen=g_edge, dtype=bf)
    for cin, cout in ((64, 24), (96, 96)):
        preact_case(he, we, cin=cin, cout=cout, gen=g_edge, dtype=bf)
    # the bf16 forms of the backward kernels at the train shapes, from a
    # generator of their own
    g17 = torch.Generator(dev).manual_seed(gen.initial_seed() + 17)
    for C, s in k5_levels + ((32, 1), (192, 8)):
        k5_case(C, T // s, gen=g17, dtype=bf)
    for label, H, cin, cout, opts in k6_shapes:
        conv_case(label, B, H, H, cin, cout, backward=True, gen=g17,
                  gen_go=g17, dtype=bf, **opts)
    return cases


def flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [out]


def phase_kernels(dev, seed, results):
    import torch
    gen = torch.Generator(dev).manual_seed(seed)
    for case in kernel_cases(gen, dev):
        name, label = case['name'], case['label']
        got, want = flat(case['kernel']()), flat(case['plain']())
        torch.cuda.synchronize()
        # tolerances, float32 on both sides: a tensor output (the gradients
        # of K5 and K6 among them, whose weight, bias and attention parts
        # are sums over up to 0.66 M pixels in another order) within 1e-4
        # of max(1, its largest magnitude); (B, C) sums and sums of squares
        # of up to 3.6 M values, added in another order (K1 per pixel tile,
        # then over the tiles; K2, K4 with atomics), within 1e-5 of the
        # largest sum of squares; a bf16 case's own `tol` (kernel_cases)
        n_out = len(got) - case['stats']
        if len(got) != len(want):
            fail('%s %s: %d results, plain gives %d'
                 % (name, label, len(got), len(want)))
        stat_scale = want[-1].abs().max().item()
        out_rel, stat_rel = case.get('tol', (1e-4, 1e-5))
        errs, rels, shares = [], [], []
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail('%s %s: result %d has shape %s %s, plain %s %s'
                     % (name, label, i, tuple(g.shape), g.dtype,
                        tuple(w.shape), w.dtype))
            errs.append((g.float() - w.float()).abs().max().item())
            big = w.abs().max().item()
            tol = (out_rel * max(1.0, big) if i < n_out
                   else stat_rel * stat_scale)
            if not errs[-1] <= tol:
                fail('%s %s: result %d max abs err %.3e > tol %.3e'
                     % (name, label, i, errs[-1], tol))
            rels.append(errs[-1] / max(big, 1e-30))
            # K1 in bf16: also at least this share of the plain version's
            # bits (as the GPU tests hold every bf16 form)
            if i < n_out and case.get('bits'):
                same = (g == w).float().mean().item()
                shares.append(same)
                if not same >= case['bits']:
                    fail('%s %s: result %d has %.4f of the plain version\'s '
                         'bits, below %.2f' % (name, label, i, same,
                                               case['bits']))
        # K1's statistics (and in bf16 K2's and K4's sums), the weight and
        # bias gradients of K5 and K6, and K5's attention gradients are added
        # in a fixed order: a second call gives the same bits
        if case.get('fixed'):
            again = flat(case['kernel']())
            for i in case['fixed']:
                if not torch.equal(got[i], again[i]):
                    fail('%s %s: result %d differs between two calls'
                         % (name, label, i))
            del again
        del got, want
        err = errs[0]   # the first output's (gn1_stats: the sums')
        ms = timed(case['kernel'], 5)
        plain_ms = timed(case['plain'], 5)
        lib_ms = timed(case['library'], 5) if case['library'] else None
        t_bytes = 1e3 * case['bytes'] / HBM_BYTES_PER_S
        rate = case.get('flop_per_s', FP32_FLOP_PER_S)
        t_flop = 1e3 * case['flop'] / rate
        # a bf16 form's product as fp32 FMA: its issue time, for comparison
        t_fma = 1e3 * case['flop'] / FP32_FLOP_PER_S
        r = results.setdefault(name, {
            'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
            'bytes_ms': 0.0, 'flop_ms': 0.0, 'library_ms': None})
        r['max_abs_err'] = max(r['max_abs_err'], err)
        r['ms'] += ms
        r['plain_ms'] += plain_ms
        r['bound_ms'] += max(t_bytes, t_flop)
        r['bytes_ms'] += t_bytes
        r['flop_ms'] += t_flop
        if lib_ms is not None:
            r['library_ms'] = (r['library_ms'] or 0.0) + lib_ms
        say('kernels', '%-13s %-44s max_abs_err %.3e (largest rel %s)  '
            'kernel %.3f ms  plain %.3f ms  library %s  bound %.3f ms '
            '(%s)%s%s%s'
            % (name, label, err,
               ' '.join('%.1e' % v for v in rels) if case.get('fixed')
               else '%.1e' % max(rels), ms, plain_ms,
               'none' if lib_ms is None else '%.3f ms' % lib_ms,
               max(t_bytes, t_flop),
               'bytes' if t_bytes > t_flop else 'operations at %.0f TFLOP/s'
               % (rate / 1e12),
               '' if t_fma == t_flop else
               '  fp32 FMA issue %.3f ms at 67 TFLOP/s' % t_fma,
               '; results %s bit-identical in a second call'
               % (case['fixed'],)
               if case.get('fixed') else '',
               "; share of the plain version's bits %s"
               % ' '.join('%.4f' % v for v in shares) if shares else ''))
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phases 3-5
def sid_model(**unet):
    """The SID model options; `unet` overrides (dropout=0.0 folds the head,
    tail= chooses the AKGM tail)."""
    from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
    model = copy.deepcopy(SID_MODEL)
    model['beta_schedule']['val'] = dict(SID_VAL_SCHEDULE)
    model['unet'].update(unet)
    return model


def build_model(seed, **unet):
    import torch
    from ucdir_tpu_torch.models.factory import define_G
    torch.manual_seed(seed)
    return define_G({'model': sid_model(**unet)}).eval()


def injected(draws, d):
    """noise= for eval_step: the numpy draws in order, on device d."""
    import torch
    it = iter(draws)
    return lambda shape: torch.from_numpy(next(it)).to(d)


def agree(phase, what, got, want, tol=1e-5):
    """Fails unless two results of one function, float32 on both sides with
    sums in other orders (atomics, cuDNN, oneDNN) through ~70 layers and a
    few steps, agree within `tol` abs on outputs in about [-2, 2]. Sound
    readings on an H100 are up to 6.6e-7 for DDPM steps, so 1e-5 leaves a
    margin of 15x; DDIM reads 5.4e-6 (its first step turns eps into x0 with
    a factor of 1 / sqrt(abar_49), some hundreds, before the clip)."""
    import torch
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail('%s: %s has shape %s or non-finite values'
             % (phase, what, tuple(got.shape)))
    err = (got - want).abs().max().item()
    if not err <= tol:
        fail('%s: %s max abs err %.3e > %.0e' % (phase, what, err, tol))
    return err


def pattern(h, w, seed):
    """A smooth (1, h, w, 3) target in [-1, 1] and its degraded version."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    yy, xx = yy / (h - 1.0), xx / (w - 1.0)
    hr = np.stack([np.sin(3 * xx + c) * np.cos(2 * yy - c) for c in range(3)],
                  axis=-1).astype(np.float32)
    lq = np.clip(0.1 * hr + rng.normal(0, 0.1, hr.shape), -1, 1)
    return hr[None], lq[None].astype(np.float32)


def phase_slice(dev, seed):
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.schedule import make_schedule

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
    shape = (1, 96 + 2 * PAD, 96 + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=2)
    host = build_model(seed)
    card = copy.deepcopy(host).to(dev)
    outs = {}
    for name, model, d in (('cuda', card, dev), ('cpu', host, 'cpu')):
        t = time.perf_counter()
        outs[name] = eval_step(
            model, make_schedule(sched_opt, d), torch.from_numpy(x).to(d),
            noise=injected(draws, d))
        if name == 'cuda':
            torch.cuda.synchronize()
        outs[name + '_s'] = time.perf_counter() - t
    for i, what in enumerate(('sr', 'initx')):
        err = agree('slice', what + ' card vs host', outs['cuda'][i],
                    outs['cpu'][i])
        say('slice', '%s card vs host max abs err %.3e (tol 1e-5)'
            % (what, err))
    say('slice', 'full width, 96x96 input, 2 steps: card %.2f s, host %.2f s'
        % (outs['cuda_s'], outs['cpu_s']))


def phase_main(dev, seed, compute_dtype=None, phase='main'):
    """Trainer.test on a 96 x 96 pair, `compute_dtype` as the CLI's
    --compute_dtype (None or 'bf16'); every kernel that `phase` owns must
    launch. Returns the launches."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.metrics import core as Metrics
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import Trainer

    opt = {'phase': 'val', 'model': sid_model(),
           'path': {'resume_state': None}, 'compute_dtype': compute_dtype,
           'train': {'ema_scheduler': {'use': True}}}
    trainer = Trainer(opt, device=dev, seed=seed)
    hr, lq = pattern(96, 96, seed + 2)
    trainer.feed_data({'SR': lq, 'HR': hr})
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    trainer.test(continous=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    TC[phase] = _build.tc_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    sr = trainer.get_current_visuals()['SR']
    if sr.shape != (11, 96, 96, 3) or not np.isfinite(sr).all():
        fail('%s: snapshots have shape %s or non-finite values'
             % (phase, sr.shape))
    psnr = Metrics.calculate_psnr(Metrics.tensor2img(sr[-1]),
                                  Metrics.tensor2img(hr[0]))
    if not math.isfinite(psnr):
        fail('%s: PSNR %r' % (phase, psnr))
    missing = [k for k, n in launches.items()
               if n == 0 and OWNER[k] == phase]
    if missing:
        fail('%s: kernels never launched on the main path: %s'
             % (phase, missing))
    say(phase, 'Trainer.test 50 steps%s, full width, 96x96: %.2f s, PSNR '
        '%.4f dB (random weights; SSIM skipped: needs cv2), peak %.3f GiB, '
        'launches %s' % ('' if compute_dtype is None else ' in ' +
                         compute_dtype, secs, psnr, peak,
                         json.dumps(launches)))
    return launches


def phase_sid(dev, seed, compute_dtype=None, phase='sid'):
    """One SID frame through the validation step, the networks in
    `compute_dtype` (None: float32). Returns (the restored frame on the
    host, the launches of that run)."""
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.diffusion.sampler import cast_model
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.models.dy3h import compute_guide_maps
    from ucdir_tpu_torch.models.layers import pad_to_multiple, reflect_pad
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    model = build_model(seed).to(dev)
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=SID_STEPS), dev)
    steps = sched.num_timesteps
    gen = torch.Generator(dev).manual_seed(seed)
    frame = torch.rand((1,) + SID_FRAME + (3,), generator=gen,
                       device=dev) * 2 - 1
    with torch.no_grad():
        # the predictor and the guide maps alone, to split the frame's time
        net = model if compute_dtype is None else cast_model(model,
                                                             compute_dtype)
        x = reflect_pad(frame, PAD, PAD, PAD, PAD).to(
            compute_dtype or frame.dtype)
        torch.cuda.synchronize()
        t = time.perf_counter()
        compute_guide_maps(net.denoise_fn,
                           pad_to_multiple(net.predict_init(x), 32)[0])
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t
        del x, net
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t = time.perf_counter()
    sr, _ = eval_step(model, sched, frame, pad=PAD, generator=gen,
                      compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    TC[phase] = _build.tc_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if (sr.shape != frame.shape or sr.dtype != torch.float32
            or not torch.isfinite(sr).all()):
        fail('%s: output has shape %s, dtype %s or non-finite values'
             % (phase, tuple(sr.shape), sr.dtype))
    say(phase, 'frame %dx%d (network %dx%d), %d steps%s: %.3f s for the '
        'frame; predictor + guide maps %.1f ms, %.1f ms per DY3h step, peak '
        '%.3f GiB, launches %s'
        % (SID_FRAME + NET_FRAME + (
            steps, '' if compute_dtype is None else ' in %s' % compute_dtype,
            t_frame, 1e3 * t_pre, 1e3 * (t_frame - t_pre) / steps, peak,
            json.dumps(launches))))
    return sr.cpu(), launches


def bf16_slice(dev, seed, **unet):
    """phase_slice's restoration in bf16, card against host: the mean abs
    difference within 1e-3 (outputs in about [-2, 2]; both sides round at
    the same places, but a float32 sum in another order flips a bf16
    output's last bit, 2^-8 at 1, and the flip runs on through the network
    and the steps), the max printed. Returns the card run's launches."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
    shape = (1, 96 + 2 * PAD, 96 + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=2)
    host = build_model(seed, **unet)
    card = copy.deepcopy(host).to(dev)
    outs = {}
    for name, model, d in (('cuda', card, dev), ('cpu', host, 'cpu')):
        if name == 'cuda':
            torch.cuda.synchronize()
            _build.reset_launches()
        outs[name] = eval_step(
            model, make_schedule(sched_opt, d), torch.from_numpy(x).to(d),
            noise=injected(draws, d), compute_dtype=torch.bfloat16)
        if name == 'cuda':
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
    what = 'slice, %s' % (unet or 'the SID model')
    for i, out in enumerate(('sr', 'initx')):
        got, want = outs['cuda'][i].cpu(), outs['cpu'][i]
        if (got.shape != want.shape or got.dtype != torch.float32
                or not torch.isfinite(got).all()):
            fail('bf16: %s %s has shape %s, dtype %s or non-finite values'
                 % (what, out, tuple(got.shape), got.dtype))
        d = (got - want).abs()
        mean, big = d.mean().item(), d.max().item()
        if not mean <= 1e-3:
            fail('bf16: %s %s card vs host mean abs %.3e > 1e-3'
                 % (what, out, mean))
        say('bf16', '%s: %s card vs host mean abs %.3e (tol 1e-3), max abs '
            '%.3e' % (what, out, mean, big))
    return launches


def phase_bf16(dev, seed, counts, sr32):
    """Validation under --compute_dtype bf16: the slice, the `dropout: 0`
    slice (K7's bf16 form), Trainer.test, and phase_sid's frame against its
    float32 result `sr32`."""
    import torch
    from ucdir_tpu_torch.ops import _build
    bf = torch.bfloat16
    bf16_slice(dev, seed)
    counts['bf16_head'] = bf16_slice(dev, seed, dropout=0.0)
    TC['bf16_head'] = _build.tc_launches()
    phase_main(dev, seed, 'bf16', phase='bf16')
    sr, counts['bf16'] = phase_sid(dev, seed, bf, phase='bf16')
    missing = [k for k, owner in OWNER.items()
               if owner == 'bf16' and counts['bf16'][k] == 0]
    if missing:
        fail('bf16: bf16 kernels never launched on the bf16 frame: %s'
             % missing)
    if counts['bf16_head']['conv3x3_preact_bf16'] == 0:
        fail('bf16: the dropout: 0 model never launched conv3x3_preact_bf16')
    # K1, K2, K3 and K7 in bf16 run on the tensor cores at every launch; no
    # other kernel of the frame does, and none of the float32 frame
    for path in ('bf16', 'bf16_head', 'sid'):
        tensor_cores_only(path, counts[path])
    d = (sr - sr32).abs()
    mean = d.mean().item()
    if not mean <= 0.05:
        fail('bf16: frame bf16 vs float32 mean abs %.3e > 0.05' % mean)
    say('bf16', 'frame, bf16 against float32 (same draws): mean abs %.3e '
        '(tol 0.05, the JAX test of bf16 sampling; CLAUDE.md states about '
        '0.001 for the JAX rounds), max abs %.3e' % (mean, d.max().item()))


# ------------------------------------------------------------- phases 6-7
def phase_train_slice(dev, seed, compute_dtype=None, **unet):
    """Two AdamW steps of the full-width model (`unet` overrides) on a 64 x
    64 batch of 2 with dropout off and injected draws, on the card (kernels
    K1..K6) and on the host (their plain versions), the networks in
    `compute_dtype` (None: float32; bf16 on float32 masters: the bf16 forms
    of K1..K6, and no float32 kernel, on the card). Returns the card run's
    launches."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_MODEL
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule
    from ucdir_tpu_torch.train import (create_train_state, make_optimizer,
                                       train_step)

    rng = np.random.default_rng(seed + 3)
    hr = rng.uniform(-0.8, 0.8, (2, 64, 64, 3)).astype(np.float32)
    batch = {'HR': hr, 'SR': (0.2 * hr + rng.normal(0, 0.05, hr.shape))
             .astype(np.float32)}
    draws = [{'gammas': rng.uniform(0.3, 0.95, (2, 1)).astype(np.float32),
              'noise': rng.standard_normal(hr.shape).astype(np.float32)}
             for _ in range(2)]
    host = build_model(seed, **unet)   # eval(): dropout off, autograd on
    card = copy.deepcopy(host).to(dev)
    run = {}
    dtype = {None: None, 'bf16': torch.bfloat16}[compute_dtype]
    for name, model, d in (('cuda', card, dev), ('cpu', host, 'cpu')):
        if name == 'cuda':
            torch.cuda.synchronize()
            _build.reset_launches()
        state = create_train_state(
            model, make_optimizer(model.parameters(), {'type': 'adamw',
                                                       'lr': 1e-4}))
        sched = make_schedule(SID_MODEL['beta_schedule']['train'], d)
        on = lambda tree: {k: torch.from_numpy(v).to(d)
                           for k, v in tree.items()}
        t = time.perf_counter()
        losses, grads = [], None
        for step_draws in draws:
            losses.append(train_step(state, sched, on(batch),
                                     draws=on(step_draws),
                                     compute_dtype=dtype).item())
            if grads is None:
                grads = {k: p.grad.detach().cpu().clone()
                         for k, p in model.named_parameters()}
        if name == 'cuda':
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        masters = [p.dtype for p in model.parameters()] + [
            v.dtype for st in state.optimizer.state.values()
            for v in st.values() if torch.is_tensor(v)] + [
            g.dtype for g in grads.values()]
        if any(dt != torch.float32 for dt in masters):
            fail('train_slice: a master weight, gradient or optimizer state '
                 'is not float32')
        run[name] = (losses, grads,
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}, time.perf_counter() - t)
    (l_c, g_c, p_c, s_c), (l_h, g_h, p_h, s_h) = run['cuda'], run['cpu']
    suffix = '' if dtype is None else '_bf16'
    path = ('akgm_tail', 'conv3x3', 'conv1x1', 'gn1_stats', 'akgm_tail_bwd',
            'conv3x3_bwd')
    missing = [k + suffix for k in path if launches[k + suffix] == 0]
    if missing:
        fail('train_slice: kernels never launched: %s' % missing)
    other = [k for k, n in launches.items()
             if n and (k.endswith('_bf16') != (dtype is not None))]
    if other:
        fail('train_slice: launched kernels of the other dtype: %s' % other)
    # float32 on both sides, sums in other orders (atomics, cuDNN, oneDNN)
    # through ~70 layers forward and back. Limits from readings on an H100
    # (PERF.md): the first loss within 1e-5 rel and the second, taken on
    # weights that AdamW's sign-like first step has moved, within 1e-4 rel
    # (readings: equal to 8 digits); a gradient within 1e-3 of that
    # parameter's largest gradient plus 1e-6 (the L1 loss's gradient is a
    # sign, which flips where the prediction error rounds across 0); a
    # parameter after 2 steps of lr 1e-4 within 4.04e-4, the most that
    # AdamW's sign-like first steps can differ (2 * lr each way).
    # bf16: both sides round at the same places, and a float32 sum in
    # another order flips a bf16 value's last bit, 2^-8 of it, which runs
    # on through the network: each loss within 1e-3 rel; the gradients'
    # distance is printed, not held (a flipped rounding of a layer's output
    # moves a whole layer's weight gradient by about a bf16 ulp); the
    # parameters after, as in float32, within the 2 * lr a step that
    # AdamW's sign-like steps allow.
    for i, (a, b) in enumerate(zip(l_c, l_h)):
        tol = 1e-3 if dtype is not None else 1e-5 if i == 0 else 1e-4
        if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
            fail('train_slice: step %d loss %.8g on the card, %.8g on the '
                 'host' % (i, a, b))
    g_err = p_err = p_mean = 0.0
    for k, want in g_h.items():
        if g_c[k] is None or not torch.isfinite(g_c[k]).all():
            fail('train_slice: gradient of %s missing or non-finite' % k)
        scale = want.abs().max().item()
        err = (g_c[k] - want).abs().max().item()
        if dtype is None and not err <= 1e-3 * scale + 1e-6:
            fail('train_slice: gradient of %s: max abs err %.3e, largest '
                 'gradient %.3e' % (k, err, scale))
        g_err = max(g_err, err / max(scale, 1e-30))
    n = 0
    for k, want in p_h.items():
        diff = (p_c[k] - want).abs()
        if not diff.max().item() <= 4.04e-4:
            fail('train_slice: parameter %s differs by %.3e after 2 steps'
                 % (k, diff.max().item()))
        p_err = max(p_err, diff.max().item())
        p_mean += diff.sum().item()
        n += diff.numel()
    say('train_slice', '%s%s, 64x64, batch 2, 2 AdamW steps: losses '
        'card %s host %s (tol %s rel); largest gradient err %.3e of its '
        'parameter\'s largest gradient (%s); parameters after: max diff '
        '%.3e (tol 4.04e-4), mean diff %.3e; card %.2f s, host %.2f s; '
        'launches %s'
        % (json.dumps(unet) if unet else 'full width',
           '' if dtype is None else ' in bf16 on float32 masters',
           json.dumps(l_c), json.dumps(l_h),
           '1e-5, 1e-4' if dtype is None else '1e-3', g_err,
           'tol 1e-3' if dtype is None else 'printed', p_err, p_mean / n,
           s_c, s_h, json.dumps(launches)))
    return launches


def train_opt(tmp, compute_dtype=None):
    """The SID train options of the `train` phases, checkpoints under
    `tmp`."""
    from ucdir_tpu_torch.configs import SID_MODEL
    return {'phase': 'train', 'model': copy.deepcopy(SID_MODEL),
            'compute_dtype': compute_dtype,
            'path': {'resume_state': None,
                     'checkpoint': os.path.join(tmp, 'checkpoint')},
            'train': {'optimizer': {'type': 'adamw', 'lr': 1e-4},
                      'ema_scheduler': {'use': True, 'step_start_ema': 5000,
                                        'update_ema_every': 1,
                                        'ema_decay': 0.9999}}}


def train_batch(seed):
    """The `train` phases' batch: TRAIN_BATCH smooth crops and their
    degraded versions."""
    import numpy as np
    crop = TRAIN_CROP
    rng = np.random.default_rng(seed + 4)
    yy, xx = np.mgrid[0:crop, 0:crop] / (crop - 1.0)
    hr = np.stack([[np.sin((3 + i) * xx + c) * np.cos((2 + i) * yy - c)
                    for c in range(3)] for i in range(TRAIN_BATCH)])
    hr = np.ascontiguousarray(hr.transpose(0, 2, 3, 1)).astype(np.float32)
    lq = np.clip(0.1 * hr + rng.normal(0, 0.1, hr.shape), -1,
                 1).astype(np.float32)
    return hr, lq


def train_steps(dev, trainer, hr, lq, steps, phase):
    """`steps` optimize_parameters on the batch (halved while a step does not
    fit), the first a warm-up; fails unless the losses are finite and the
    loss on the first step's draws falls. Returns (batch, s per step, the
    losses, that loss again, peak GiB, the launches of the first step, of
    all steps)."""
    import torch
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.train import step_loss

    if not trainer.model.training:
        fail('%s: the model is not in train mode (dropout off)' % phase)
    batch = TRAIN_BATCH
    while True:   # halved while a step does not fit
        trainer.feed_data({'HR': hr[:batch], 'SR': lq[:batch]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        try:
            trainer.optimize_parameters()   # also the warm-up step
            break
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            trainer.state.optimizer.zero_grad(set_to_none=True)
            trainer.iter = trainer.state.step = 0
            batch //= 2
            torch.cuda.empty_cache()
    losses = [trainer.get_current_log()['l_pix']]
    per_step = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps - 1):
        trainer.optimize_parameters()
        losses.append(trainer.get_current_log()['l_pix'])
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t) / (steps - 1)
    launches = dict(_build.LAUNCHES)
    TC[phase] = _build.tc_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not all(math.isfinite(l) for l in losses):
        fail('%s: non-finite loss in %s' % (phase, losses))
    # every step draws its own noise level, noise and dropout mask, so the
    # steps' losses are not comparable one to one: the loss must fall on the
    # first step's own draws, taken again with the weights after the last
    # step
    with torch.no_grad():
        again = step_loss(trainer.model, trainer.schedules['train'],
                          {k: trainer.to_device(trainer.data[k])
                           for k in ('HR', 'SR')},
                          trainer.step_generator(0),
                          compute_dtype=trainer.compute_dtype).item()
    if not again < losses[0]:
        fail('%s: the loss on the first step\'s draws did not fall: %.6f '
             'before, %.6f after %d steps' % (phase, losses[0], again,
                                               steps))
    return batch, secs, losses, again, peak, per_step, launches


def phase_train(dev, seed):
    """The train half of the Trainer at full width and the SID train shape:
    optimize_parameters on one seeded batch, save_network, reload, test."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.trainer import Trainer

    steps, crop = TRAIN_STEPS, TRAIN_CROP
    hr, lq = train_batch(seed)
    with tempfile.TemporaryDirectory() as tmp:
        opt = train_opt(tmp)
        trainer = Trainer(opt, device=dev, seed=seed)
        batch, secs, losses, again, peak, per_step, launches = train_steps(
            dev, trainer, hr, lq, steps, 'train')
        missing = [k for k, n in launches.items()
                   if n == 0 and OWNER[k] in ('main', 'train')]
        if missing:
            fail('train: kernels never launched on the train path: %s'
                 % missing)
        say('train', 'Trainer.optimize_parameters, full width, crop %d '
            '(network %dx%d), batch %d, AdamW 1e-4, dropout 0.1, no '
            'activation checkpointing: %.3f s per step (mean of %d after the '
            'first), losses %s, the first step\'s draws again after the last '
            'step %.6f, peak %.3f GiB, launches per step %s, in %d '
            'steps %s' % (crop, TRAIN_NET, TRAIN_NET, batch, secs, steps - 1,
                          json.dumps([round(l, 6) for l in losses]), again,
                          peak,
                          json.dumps(per_step), steps, json.dumps(launches)))

        prefix = trainer.save_network(1, steps)
        live = {k: v.detach().clone()
                for k, v in trainer.model.state_dict().items()}
        ema = {k: v.clone() for k, v in trainer.state.ema_params.items()}
        del trainer
        torch.cuda.empty_cache()
        val_model = sid_model()
        resumed = Trainer(dict(opt, path=dict(opt['path'],
                                              resume_state=prefix)),
                          device=dev, seed=seed)
        if resumed.iter != steps or any(
                not torch.equal(v, live[k])
                for k, v in resumed.model.state_dict().items()):
            fail('train: the resumed trainer differs from the one saved')
        del resumed
        val = Trainer({'phase': 'val', 'model': val_model,
                       'path': {'resume_state': prefix},
                       'train': opt['train']}, device=dev, seed=seed)
        if any(not torch.equal(v, ema[k])
               for k, v in val.model.state_dict().items()):
            fail('train: the validation trainer did not load the EMA weights')
        val.feed_data({'SR': lq[:1, :96, :96], 'HR': hr[:1, :96, :96]})
        t = time.perf_counter()
        val.test(continous=False)
        torch.cuda.synchronize()
        sr = val.get_current_visuals()['SR']
        if sr.shape != (1, 96, 96, 3) or not np.isfinite(sr).all():
            fail('train: test after the reload gave shape %s or non-finite '
                 'values' % (sr.shape,))
        say('train', 'save_network -> %s_{gen,gen_ema,opt}.pth, resumed at '
            'step %d bit for bit, EMA weights reloaded, Trainer.test 96x96, '
            '50 steps: %.2f s' % (os.path.basename(prefix), steps,
                                  time.perf_counter() - t))
    return launches


def tensor_cores_only(path, launches):
    """Fails unless every launch on `path` of an entry point of the
    tensor-core core (`_build.TC_ENTRIES`: K1, K2, K3, K5, K6 and K7 in
    bf16)
    went through it, and no other entry point's did."""
    from ucdir_tpu_torch.ops import _build
    wrong = {k: (TC[path][k], n) for k, n in launches.items()
             if TC[path][k] != (n if k in _build.TC_ENTRIES else 0)}
    if wrong:
        fail('%s: launches through the tensor cores, of all launches: %s'
             % (path, wrong))
    say(path, 'launches through the tensor-core core, of all: %s'
        % json.dumps({k: [TC[path][k], launches[k]]
                      for k in _build.TC_ENTRIES}))


def phase_train_bf16(dev, seed):
    """`train`'s steps with --compute_dtype bf16: the networks on a bf16
    cast of the float32 masters. Fails unless every step launched the bf16
    forms of K1..K6 and no float32 kernel, and the masters, gradients,
    optimizer state, EMA shadow and saved weights stay float32. Returns the
    launches."""
    import torch
    from ucdir_tpu_torch.trainer import Trainer

    steps = BF16_TRAIN_STEPS
    hr, lq = train_batch(seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(train_opt(tmp, 'bf16'), device=dev, seed=seed)
        batch, secs, losses, again, peak, per_step, launches = train_steps(
            dev, trainer, hr, lq, steps, 'train_bf16')
        missing = [k for k, owner in OWNER.items()
                   if owner == 'train_bf16' and launches[k] == 0]
        other = [k for k, n in launches.items()
                 if n and not k.endswith('_bf16')]
        if missing or other:
            fail('train_bf16: bf16 kernels never launched: %s; float32 '
                 'kernels launched: %s' % (missing, other))
        tensor_cores_only('train_bf16', launches)
        state = trainer.state
        tensors = list(trainer.model.parameters()) + [
            p.grad for p in trainer.model.parameters()] + list(
            state.ema_params.values()) + [
            v for st in state.optimizer.state.values() for v in st.values()
            if torch.is_tensor(v)]
        prefix = trainer.save_network(1, steps)
        for suffix in ('_gen.pth', '_gen_ema.pth'):
            tensors += torch.load(prefix + suffix,
                                  weights_only=True).values()
        if any(t.dtype != torch.float32 for t in tensors):
            fail('train_bf16: a master weight, gradient, optimizer state, '
                 'EMA or saved weight is not float32')
        say('train_bf16', 'Trainer.optimize_parameters with compute_dtype '
            'bf16, full width, crop %d (network %dx%d), batch %d, AdamW 1e-4, '
            'dropout 0.1: %.3f s per step (mean of %d after the first), '
            'losses %s, the first step\'s draws again after the last step '
            '%.6f, peak %.3f GiB; masters, gradients, optimizer state, EMA '
            'and saved weights float32; launches per step %s, in %d steps %s'
            % (TRAIN_CROP, TRAIN_NET, TRAIN_NET, batch, secs, steps - 1,
               json.dumps([round(l, 6) for l in losses]), again, peak,
               json.dumps(per_step), steps, json.dumps(launches)))
    return launches


# ------------------------------------------------------------ phases 8-10
def phase_variants(dev, seed, counts):
    """The `dropout: 0` model under each AKGM tail, card against host."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    steps, size = 2, 256
    rng = np.random.default_rng(seed + 5)
    x = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    shape = (1, size + 2 * PAD, size + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(steps + 1)]
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=steps)
    weights = build_model(seed, dropout=0.0).state_dict()
    on_card = {}
    for tail in ('fused', 'mix', 'packed'):
        host = build_model(seed, dropout=0.0, tail=tail)
        host.load_state_dict(weights, strict=True)   # one set for all tails
        card = copy.deepcopy(host).to(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        got = eval_step(card, make_schedule(sched_opt, dev),
                        torch.from_numpy(x).to(dev),
                        noise=injected(draws, dev))[0]
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t
        n = counts['variants_' + tail] = dict(_build.LAUNCHES)
        t = time.perf_counter()
        want = eval_step(host, make_schedule(sched_opt, 'cpu'),
                         torch.from_numpy(x), noise=injected(draws, 'cpu'))[0]
        t_host = time.perf_counter() - t
        err = agree('variants', "tail '%s' card vs host" % tail, got, want)
        per_step = {'fused': ('akgm_tail', 'akgm_mix', 'akgm_packed'),
                    'mix': ('akgm_mix', 'akgm_tail', 'akgm_packed'),
                    'packed': ('akgm_packed', 'akgm_tail', 'akgm_mix')}[tail]
        expect = {'conv3x3_preact': steps, per_step[0]: BLOCKS * steps,
                  per_step[1]: 0, per_step[2]: 0}
        wrong = {k: n[k] for k, v in expect.items() if n[k] != v}
        if wrong:
            fail("variants: tail '%s' launched %s, expected %s"
                 % (tail, wrong, expect))
        on_card[tail] = got
        say('variants', "tail '%s', dropout 0, full width, %dx%d, %d DDPM "
            'steps: card vs host max abs err %.3e (tol 1e-5); card %.2f s, '
            'host %.2f s; launches %s'
            % (tail, size, size, steps, err, t_card, t_host, json.dumps(n)))
    err = agree('variants', "tail 'mix' vs tail 'fused' on the card",
                on_card['mix'], on_card['fused'])
    far = (on_card['packed'] - on_card['fused']).abs().max().item()
    say('variants', "'mix' vs 'fused' on the card: max abs err %.3e (tol "
        "1e-5, the same function); 'packed' vs 'fused': %.3e (another "
        'network)' % (err, far))


def phase_fewstep(dev, seed, counts):
    """The few-step samplers on one SID frame, `dropout: 0` model."""
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.metrics import core as Metrics
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    host = build_model(seed, dropout=0.0)
    model = copy.deepcopy(host).to(dev)
    sched = make_schedule(SID_VAL_SCHEDULE, dev)
    hr, lq = pattern(*SID_FRAME, seed + 6)
    frame = torch.from_numpy(lq).to(dev)
    gen = torch.Generator(dev).manual_seed(seed)
    total = {}
    runs = [(s, n, None) for s, n in (('ddim', 5), ('dpmpp', 20),
                                      ('dpmpp_sde', 20))]
    runs += [(s, n, torch.bfloat16) for s, n, _ in runs]
    for sampler, steps, dtype in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        sr, _ = eval_step(model, sched, frame, pad=PAD, generator=gen,
                          sampler=sampler, sampling_timesteps=steps,
                          compute_dtype=dtype)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        n = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if sr.shape != frame.shape or not torch.isfinite(sr).all():
            fail('fewstep: %s output has shape %s or non-finite values'
                 % (sampler, tuple(sr.shape)))
        sfx = '' if dtype is None else '_bf16'
        if (n['conv3x3_preact' + sfx] != steps
                or n['akgm_tail' + sfx] != BLOCKS * steps):
            fail('fewstep: %s, %d steps, in %s, launched %s'
                 % (sampler, steps, dtype, n))
        psnr = Metrics.calculate_psnr(Metrics.tensor2img(sr[0].cpu().numpy()),
                                      Metrics.tensor2img(hr[0]))
        if not math.isfinite(psnr):
            fail('fewstep: %s PSNR %r' % (sampler, psnr))
        if dtype is None:
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
        say('fewstep', '%s, %d steps%s, frame %dx%d: %.3f s per frame, %.1f '
            'ms per step (the predictor and the guide maps included), PSNR '
            '%.4f dB (random weights), peak %.3f GiB, launches %s'
            % ((sampler, steps, '' if dtype is None else ' in bf16')
               + SID_FRAME
               + (secs, 1e3 * secs / steps, psnr, peak, json.dumps(n))))
        del sr
    counts['fewstep'] = total

    err = agree('fewstep', 'ddim card vs host',
                *ddim_card_and_host(dev, seed, model, host))
    say('fewstep', 'ddim, 3 steps, full width, 64x64: card vs host max abs '
        'err %.3e (tol 1e-5)' % err)


def ddim_card_and_host(dev, seed, model, host):
    """The `dropout: 0` model on the card and on the host restores one 64 x
    64 input with ddim, 3 steps, on the shipped 50-step schedule and the
    same injected draws: (card's output, host's output)."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.schedule import make_schedule

    rng = np.random.default_rng(seed + 7)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    shape = (1, 64 + 2 * PAD, 64 + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    kw = dict(sampler='ddim', sampling_timesteps=3)
    got = eval_step(model, make_schedule(SID_VAL_SCHEDULE, dev),
                    torch.from_numpy(x).to(dev), noise=injected(draws, dev),
                    **kw)[0]
    want = eval_step(host, make_schedule(SID_VAL_SCHEDULE, 'cpu'),
                     torch.from_numpy(x), noise=injected(draws, 'cpu'),
                     **kw)[0]
    return got, want


def phase_hires(dev, seed, counts):
    """One full-resolution frame through the tiled path, and the tiled path
    card against host at a small size."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.parallel.tiled import (_grid_pad,
                                                compute_tile_starts)
    from ucdir_tpu_torch.schedule import make_schedule

    host = build_model(seed, dropout=0.0)
    model = copy.deepcopy(host).to(dev)
    sched = make_schedule(SID_VAL_SCHEDULE, dev)
    steps = 5
    gen = torch.Generator(dev).manual_seed(seed)
    frame = torch.rand((1,) + FULL_FRAME + (3,), generator=gen,
                       device=dev) * 2 - 1
    h, w = FULL_FRAME[0] + 2 * PAD, FULL_FRAME[1] + 2 * PAD
    pd = _grid_pad(h, w, TILE, PAD)
    tiles = len(compute_tile_starts(h + 2 * pd, w + 2 * pd, TILE, PAD))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    sr, _ = eval_step(model, sched, frame, pad=PAD, generator=gen,
                      sampler='ddim', sampling_timesteps=steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    n = counts['hires'] = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if sr.shape != frame.shape or not torch.isfinite(sr).all():
        fail('hires: output has shape %s or non-finite values'
             % (tuple(sr.shape),))
    if n['conv3x3_preact'] != tiles * steps:
        fail('hires: %d tiles, %d steps, but %d launches of the head kernel'
             % (tiles, steps, n['conv3x3_preact']))
    say('hires', 'frame %dx%d (%dx%d padded), ddim %d steps, tiled: %.3f s '
        'per frame, %.3f s per step (the predictor and the guide maps of '
        'every tile included), %d tiles of %dx%d per step, peak %.3f GiB, '
        'launches %s'
        % (FULL_FRAME + (h, w, steps, secs, secs / steps, tiles, TILE, TILE,
                         peak, json.dumps(n))))
    del sr
    torch.cuda.empty_cache()

    # the same frame tiled in bf16, 2 steps: its peak must stay below the
    # float32 frame's (attention's float32 scores of 16384 tokens a window
    # are the same bytes in both; every other activation is half)
    steps, peak32 = 2, peak
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    sr, _ = eval_step(model, sched, frame, pad=PAD, generator=gen,
                      sampler='ddim', sampling_timesteps=steps,
                      compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    n = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if sr.shape != frame.shape or not torch.isfinite(sr).all():
        fail('hires: bf16 output has shape %s or non-finite values'
             % (tuple(sr.shape),))
    if (n['conv3x3_preact_bf16'] != tiles * steps
            or n['akgm_tail_bf16'] != BLOCKS * tiles * steps):
        fail('hires: bf16, %d tiles, %d steps, launched %s'
             % (tiles, steps, n))
    if not peak < peak32:
        fail('hires: bf16 peak %.3f GiB, not below float32\'s %.3f GiB'
             % (peak, peak32))
    say('hires', 'the same frame in bf16, ddim %d steps, tiled: %.3f s per '
        'frame, %.3f s per step, peak %.3f GiB (float32 %.3f GiB), launches '
        '%s' % (steps, secs, secs / steps, peak, peak32, json.dumps(n)))
    del sr, frame
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 8)
    x = rng.uniform(-1, 1, (1, 200, 260, 3)).astype(np.float32)
    shape = (1, 200 + 2 * PAD, 260 + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=2)
    tile = {'skip': 128, 'padding': 16}
    _build.reset_launches()
    got = eval_step(model, make_schedule(sched_opt, dev),
                    torch.from_numpy(x).to(dev), noise=injected(draws, dev),
                    tile=tile)[0]
    n = dict(_build.LAUNCHES)
    want = eval_step(host, make_schedule(sched_opt, 'cpu'),
                     torch.from_numpy(x), noise=injected(draws, 'cpu'),
                     tile=tile)[0]
    err = agree('hires', 'tiled card vs host', got, want)
    say('hires', 'tiled {skip: 128, padding: 16}, full width, 200x260, 2 '
        'DDPM steps: card vs host max abs err %.3e (tol 1e-5), %d tiles per '
        'step' % (err, n['conv3x3_preact'] // 2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script measures the '
              'port on a CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ucdir_tpu_torch  # noqa: F401  (fails where the port is absent)

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    # the plain versions and the predictor in full float32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say('build', 'python %s, torch %s, CUDA %s; card %s (%s)'
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           card, smi))

    results = {}
    phase_build()
    phase_kernels(dev, args.seed, results)
    phase_slice(dev, args.seed)
    counts = {'main': phase_main(dev, args.seed)}
    sr32, counts['sid'] = phase_sid(dev, args.seed)
    phase_bf16(dev, args.seed, counts, sr32)
    del sr32
    counts['train_slice'] = phase_train_slice(dev, args.seed)
    counts['train_slice_24'] = phase_train_slice(dev, args.seed,
                                                 inner_channel=24)
    counts['train_slice_bf16'] = phase_train_slice(dev, args.seed, 'bf16')
    counts['train'] = phase_train(dev, args.seed)
    counts['train_bf16'] = phase_train_bf16(dev, args.seed)
    phase_variants(dev, args.seed, counts)
    phase_fewstep(dev, args.seed, counts)
    phase_hires(dev, args.seed, counts)
    unlaunched = [k for k in KERNELS if counts[OWNER[k]][k] == 0]
    if unlaunched:
        fail('kernels never launched on the path that owns them: %s'
             % unlaunched)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': counts[OWNER[name]][name],
            # of those, the launches through the tensor-core core (None:
            # not read on that path)
            'tc_launches': TC.get(OWNER[name], {}).get(name),
            'launches_by_path': {k: v[name] for k, v in counts.items()},
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': ('bytes' if r['bytes_ms'] > r['flop_ms']
                         else 'operations'),
            'library_ms': r['library_ms']})
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
