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
              36), widths of narrower models. K1, K2 (with statistics), K4,
              K5 and K6 run twice: K1's, K2's and K4's statistics (per pixel
              tile, then added in a fixed order; no atomics),
              K5's and K6's weight and bias gradients (and K5's attention
              gradients) must be equal bit for bit; K6's library
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
              the tensor cores. The float32 K5 and K6 are held against
              their plain versions evaluated in float64 (the float32 plain
              version's weight gradients are 1.5e-4 of the largest from
              float64, the kernels' 4e-6; `tools/torch_conv_accuracy.py
              --gradients`); the plain time is the float32 one's. Last, the
              forms that an AKGM block at
              norm_groups > 1 runs (its GroupNorms apart, nothing folds):
              K1 and K5 with attw and no fold, K2 and K6 with swish and no
              fold, at the folded cases' SID shapes (K1 C = 64 at the frame
              and 512 at its /8 level, K2 conv1 192 -> 64 and 1024 -> 512,
              K5 and K6 at the train shapes at C = 64 and 512), in float32
              and bf16, each a result of its own ('<kernel> nofold',
              '<kernel> nofold+swish'). The bf16 forms of K8 and K9 (on the
              tensor cores: K8 on K1's grouped product, K9 on K2's dense
              one) at the float32 rows' shapes and at C = 8, 16 and 32 on
              the frame's /8 level, K9 with fold and attw: one bf16 ulp of
              max(1, largest) and 99% of the plain version's bits; no
              library call computes either.
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
              state, EMA and the saved weights float32. Then 2 such steps
              (the first a warm-up) under each of the tails 'mix' and
              'packed': K8's or K9's bf16 form launched 27 times a step,
              through the tensor cores, the backward the autograd of the
              plain version, no float32 kernel.
  8. variants the full-width model with `dropout: 0` (folded head, K7) and
              each AKGM tail ('fused' K1, 'mix' K8, 'packed' K9) restores a
              256 x 256 input with 2 DDPM steps and injected noise on the
              card and on the host: card and host agree for every tail,
              'mix' equals 'fused' on the card, and the launch counts are
              those of the tail; then each tail in bf16 (--compute_dtype
              bf16), card against host within bf16's 1e-3 mean abs, the
              tail's bf16 form 27 times a step, every launch of a
              tensor-core entry through the tensor cores, no float32
              kernel.
  9. fewstep  the 1424 x 2128 frame through the validation step of the
              `dropout: 0` model with ddim (5 steps), dpmpp (20) and
              dpmpp_sde (20), in float32 and then in bf16: seconds per
              frame, ms per step, PSNR against a generated target, the
              launches of K1 and K7 (or their bf16 forms); and ddim, 3
              steps, 64 x 64, card against host.
 10. hires    one 2848 x 4256 frame (the full-resolution Sony frame; 2976 x
              4384 after the pad, so it runs tiled: 24 tiles of 1024 x 1024
              per step) with ddim, 5 steps: seconds per frame and per step,
              tiles per step, peak memory, K7 launches;
              the same frame in bf16 with 2 steps, its peak below the
              float32 frame's; and the tiled path ({skip: 128, padding: 16},
              200 x 260 input, 2 DDPM steps, on the resident path) card
              against host.
 10b. resident  the full-resolution frame (2976 x 4384 padded, 24 windows of
              1024) with 2 DDPM steps on the tile-resident path
              (parallel/resident.py) and on the reassembling one
              (UCDIR_TPU_NO_RESIDENT=1): the same bits in float32, s per
              step and peak of each, launches; the resident path in bf16,
              within 0.05 mean abs of the float32 frame; hires' small case
              (200 x 260, {skip: 128, padding: 16}, 2 steps of DDPM on the
              resident path and of ddim tiled;
              `hires` holds it card against host) twice, the same bits,
              then with its tiles over 2 gloo ranks sharing the card
              (subprocesses of this script,
              `--resident_worker`) and over one NCCL rank (a group of one:
              the geometry's all_reduce and the gathers run through NCCL on
              the card, the exchange has no peer), each the bits of one
              process, and over NCCL on every card where there are several
              (else a line saying why not); UCDIR_TPU_GN_SCOPE=tile with
              UCDIR_TPU_GN_TILE=64 at 200 x 260, 2 DDPM steps, card against
              host (1e-5), its unfolded K2 and K1 launched; ms per DY3h step
              on the SID frame, canvas against tile scope (1024-px windows),
              fp32 and bf16, as the difference of a 3-step and a 1-step
              frame (so the cast to bf16, the predictor and the guide maps
              drop out).
 11. tasks    the gop-deblur and jpg-restore configurations through the
              validation entry points (the port's config.parse, create_model,
              Trainer.feed_data and test; random weights, the SID model's
              full width, the schedule parse sets): one 720 x 1280 GoPro
              frame, 10 steps (a 10-step schedule, as `sid` runs); one 368 x
              496 ImageNet frame (375 x 500 after the /16 crop) degraded by
              the port's DiffJPEG at quality 10, 50 steps, in float32 and in
              bf16: seconds per frame, ms per step, peak memory, launches;
              every forward kernel (or its bf16 form) must launch.
 12. realsr   DDPM_realsr at full width with the `dopt` preset: batch 12,
              items of RealESRGANDataset (its kernel and sinc draws) made from
              generated 400 x 400 images, gt_size 256, a queue of 180; 16
              feeds (15 fill the queue, the 16th swaps), one
              optimize_parameters after each of the last 4 (the first a
              warm-up), then 4 feeds and steps on a bf16 trainer: median ms
              per feed, s per step, losses (finite), peak memory, launches of
              K1..K6 (or their bf16 forms; each must launch); usm_sharp at the
              feed's radius 15 and at the reference's default 50 (a 51 x 51
              filter); then the feed at 2 images, crop 128, gt_size 64, a
              queue of 4, on the host and on the card with the same coins and
              the host's per-sample draws replayed: HR within 1e-4, SR within
              1e-3 mean abs and 99% of it on the same 1/255 level
              (`realsr.FEED_LIMIT`).
 13. dist     batched and data-parallel runs. val_batch: the jpg-restore
              model of phase 11 restores 4 JPEG frames of 368 x 496, 10
              steps, in one Trainer.test and each alone, every image with
              injected draws of its own, in float32 and in bf16: each image
              of the batch must agree with its batch-1 restoration (float32
              1e-5 max abs, bf16 1e-3 mean abs; the kernels' tiles change
              with the batch); s per image at batch 1 and 4, every forward
              kernel launched at batch 4 (bf16 through the tensor cores); 2
              SID frames in one Trainer.test, 10 steps, float32 and bf16: s
              per image, peak. ddp: the SID train Trainer (crop 256, dropout
              0.1), 3 steps on 2 ranks of batch 2 (subprocesses of this
              script, `--ddp_worker`; NCCL with a card each where there are
              two, else gloo, both on the one card) against one process at
              batch 4, in float32 and in bf16: the losses (1e-5 rel, bf16
              1e-3), the parameters after (4.04e-4, bf16 2 * lr a step),
              the ranks' parameters, EMA and AdamW state bit for bit, their
              kernels launched (bf16 through the tensor cores); and
              `all_reduce_mean_` on a one-rank NCCL group keeps every bit of
              the one-process float32 step's gradients. Prints the backend
              and the number of cards.
 14. families every model define_G builds. The eight diffusion variants
              at the SID width (AKGM, norm_groups 1; NoDiffusion's denoiser
              on the 3-channel initx; PerceptualGaussianDiffusion on random
              LPIPS weights written to a temp file): 2
              Trainer.optimize_parameters at batch 2, crop 128, with
              injected draws and dropout off, then the card's weights
              restore one 256 x 256 input with 2 DDPM steps (NoDiffusion:
              its refine pass) through Trainer.test, card against host
              (train_slice's and variants' limits). Then the SR3-style
              network (GaussianDiffusion, resname ResnetBlock,
              GroupNorm(32)) and the AKGM network at norm_groups 32
              (ResiGaussianGuideDY) restore phase 5's frame with 10 DDPM
              steps in float32 and in bf16: ms per step, peak, launches per
              kernel and per form (every K1 launch of the norm_groups 32
              frame unfolded); both at 96 x 96 card against host in both
              dtypes (slice's gate; bf16's 1e-3 for the AKGM network, and
              for SR3's, which carries a flipped rounding further, bf16's
              own distance from float32 on the host); the norm_groups 32
              model's
              train step (batch 32, crop 256, 4 steps, the first a
              warm-up) in float32 and bf16: s per step, peak, launches per
              form. Last, GaussianDiffusion with conditional: false on SR3's
              blocks generates one 128 x 128 image with 10 steps through
              Trainer.sample, card against host.
 15. eval1    the offline evaluator (`python -m ucdir_tpu_torch.eval1 -s
              <dir>`, LPIPS and Inception on the card) over 4 generated
              result pairs of 1024 x 1024 (16 patches of 256 each) with
              random LPIPS and Inception weights: every metric line
              finite, seconds per image; the Inception features of the 64
              ground-truth patches card against host within 1e-4 of the
              largest.
Each phase's end is printed with the seconds since the build began.
Then one JSON line of kernel results (each kernel's launches from the path
that owns it: K1..K4 the main phase, K5 and K6 the train phase, K7 the
fewstep phase, K8 and K9 their variants run, the bf16 forms the bf16 frame,
K7's the bf16 `dropout: 0` slice, K5's and K6's the bf16 train steps and
K8's and K9's their tail's bf16 variants run;
every path's counts beside them (phase 13's: `dist_valbatch` the batch of
4, `dist_sid` the SID batch of 2, `dist_ddp` rank 0's steps, each also
`_bf16`), and `tc_launches`, of a kernel's launches
on its path those that went through the tensor-core core (None where the
path's were not read);
errors the largest and times summed over phase 2's shapes; then one entry
per unfolded form, its times phase 2's cases of that form and its launches
the `families` path's that runs it: the norm_groups 32 frame, or its train
steps for K5 and K6), the card's
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
GOPRO_FRAME = (720, 1280)         # a GoPro test frame, H x W
TASK_STEPS = 10                   # DDPM steps of the GoPro frame
JPEG_FRAME = (368, 496)           # a 375 x 500 ImageNet image, /16-cropped
JPEG_QUALITY = 10.                # config.parse's jpg- validation factor
REALSR_BATCH = 12                 # Real-ESRGAN's train batch
REALSR_CROP = 400                 # its dataset crop (gt_size 256)
REALSR_FEEDS = 16                 # 15 fill the queue of 180, the 16th swaps
REALSR_STEPS = 4                  # steps after the last feeds, the first a
                                  # warm-up; in bf16 the feeds too
VAL_BATCH = 4                     # the batched validation's --val_batch
SID_BATCH = 2                     # its batch at the SID frame
DDP_RANKS = 2                     # ranks of the data-parallel steps
DDP_BATCH = 2                     # their batch a rank (a global batch of 4)
DDP_STEPS = 3

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
        'akgm_tail_bwd', 'conv3x3_bwd', 'akgm_mix', 'akgm_packed')
KERNELS.update({k + '_bf16': KERNELS[k] for k in BF16})
# the path whose run gives a kernel's `launches`
OWNER = {'akgm_tail': 'main', 'conv3x3': 'main', 'conv1x1': 'main',
         'gn1_stats': 'main', 'akgm_tail_bwd': 'train',
         'conv3x3_bwd': 'train', 'conv3x3_preact': 'fewstep',
         'akgm_mix': 'variants_mix', 'akgm_packed': 'variants_packed',
         'akgm_tail_bf16': 'bf16', 'conv3x3_bf16': 'bf16',
         'conv1x1_bf16': 'bf16', 'gn1_stats_bf16': 'bf16',
         'conv3x3_preact_bf16': 'bf16_head',
         'akgm_tail_bwd_bf16': 'train_bf16', 'conv3x3_bwd_bf16': 'train_bf16',
         'akgm_mix_bf16': 'variants_mix_bf16',
         'akgm_packed_bf16': 'variants_packed_bf16'}


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

    def f64(*tensors):
        return [t.double() for t in tensors]

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

    def k1_case(C, H, W, gen=gen, dtype=f32, fold=True):
        """K1 with fold, attw and statistics, or (fold=False) with attw
        alone, as a block at norm_groups > 1 runs it; returns its
        operands."""
        h, att, w, b, kw, flop = akgm_operands(1, H, W, C, gen=gen,
                                               dtype=dtype)
        res = rnd(1, H, W, C, scale=0.5, gen=gen, dtype=dtype)
        if not fold:
            kw = dict(attw=kw['attw'])
        cases.append(dict(
            **kind('akgm_tail', dtype),
            label='C=%d %dx%d %s' % (C, H, W, 'fold+attw+stats' if fold
                                     else 'attw, no fold'),
            form=None if fold else 'nofold',
            kernel=lambda: akgm.akgm_block_tail(h, att, w, b, res, G,
                                                emit_stats=fold, **kw),
            plain=lambda: akgm.akgm_block_tail_plain(h, att, w, b, res, G,
                                                     emit_stats=fold, **kw),
            library=None, stats=2 if fold else 0,
            fixed=(1, 2) if fold else (), flop=flop,
            bits=None if dtype == f32 else 0.99,
            bytes=nbytes(h, att, w, b, res, h, *kw.values())
            + (8 * C if fold else 0)))
        return h, att, w, b, res, kw, flop

    def tail_cases_bf16(C, H, W, gen):
        """K8 and K9 in bf16 (K9 with fold and attw) against their bf16
        plain versions, each output within one bf16 ulp and 99% of the
        plain version's bits; no library call computes either."""
        bf = torch.bfloat16
        h, att, w, b, kw, flop = akgm_operands(1, H, W, C, gen=gen, dtype=bf)
        res = rnd(1, H, W, C, scale=0.5, gen=gen, dtype=bf)
        cases.append(dict(
            **kind('akgm_mix', bf), label='C=%d %dx%d' % (C, H, W),
            kernel=lambda: akgm.akgm_mix(h, att, w, b, G),
            plain=lambda: akgm.akgm_mix_reference(h, att, w, b, G),
            library=None, stats=0, flop=flop, bits=0.99,
            bytes=nbytes(h, att, w, b, h)))
        wp = akgm.pack_grouped_weight(w, G).contiguous()
        cases.append(dict(
            **kind('akgm_packed', bf),
            label='C=%d %dx%d fold+attw' % (C, H, W),
            kernel=lambda: akgm.akgm_block_tail_packed(h, att, wp, b, res, G,
                                                       **kw),
            plain=lambda: akgm.akgm_block_tail_packed_plain(
                h, att, wp, b, res, G, **kw),
            library=None, stats=0, flop=H * W * C * (2 * 9 * C + 2 * G),
            bits=0.99, bytes=nbytes(h, att, wp, b, res, h, *kw.values())))

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
        # the unfolded swish form (no stats), as a block at norm_groups > 1
        # runs conv1, is a form of its own in the results
        form = None if fold or act is None else 'nofold+swish'
        if not backward:
            stats = form is None
            kw = dict(stride=stride, act=act, emit_stats=stats,
                      norm_scale=a, norm_shift=t)
            # statistics added in a fixed order, the same bits again
            cases.append(dict(
                **kind('conv3x3', dtype), label=label, form=form,
                kernel=lambda: conv.conv3x3(x, w, b, **kw),
                plain=lambda: conv.conv3x3_plain(x, w, b, **kw),
                library=lambda: F.conv2d(nchw(x), k, b, stride=stride,
                                         padding=1),
                stats=2 if stats else 0,
                fixed=(1, 2) if stats else (), flop=flop,
                bytes=(nbytes(x, w, b, a, t) + x.element_size() * n_out
                       + (8 * B * cout if stats else 0))))
            return
        go = rnd(B, H, W, cout, gen=gen_go, dtype=dtype)
        kw = dict(act=act, norm_scale=a, norm_shift=t)
        # float32: held against the plain version in float64, as K5
        reference = None if dtype != f32 else (
            lambda: conv.conv3x3_backward_plain(
                *f64(x, w, b, go), act=act,
                **{k: v.double() for k, v in kw.items()
                   if k != 'act' and v is not None}))

        def library():
            # the input and the weight gradient, and z again where swish
            # needs it
            out = torch.ops.aten.convolution_backward(
                nchw(go), nchw(x), k, [cout], [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [True, True, True])
            return (out, F.conv2d(nchw(x), k, b, padding=1)) if act else out
        cases.append(dict(
            **kind('conv3x3_bwd', dtype), label=label, form=form,
            reference=reference,
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
        # added per slab of pixels in a fixed order, the same bits again
        cases.append(dict(
            **kind('gn1_stats', dtype), label='C=1024 %dx%d' % (h8, w8),
            kernel=lambda: stats.gn1_stats(xs),
            plain=lambda: stats.gn1_stats_plain(xs),
            library=None, stats=2, fixed=(0, 1),
            flop=3 * xs.numel(), bytes=nbytes(xs) + 8 * 1024))

    k4_case()

    # the backward kernels at the train path's shapes
    B, T = KERNEL_BATCH, TRAIN_NET

    def k5_case(C, H, gen=gen, dtype=f32, fold=True):
        h, att, w, b, kw, flop = akgm_operands(B, H, H, C, gen=gen,
                                               dtype=dtype)
        go = rnd(B, H, H, C, gen=gen, dtype=dtype)
        if not fold:
            kw = dict(attw=kw['attw'])
        # float32: held against the plain version in float64 (its float32
        # sums of up to 0.66 M pixels read 1.5e-4 of the largest weight
        # gradient from float64, `tools/torch_conv_accuracy.py --gradients`)
        reference = None if dtype != f32 else (
            lambda: akgm.akgm_block_tail_backward_plain(
                *f64(h, att, w, b, go), G,
                **{k: v.double() for k, v in kw.items()}))
        cases.append(dict(reference=reference,
            **kind('akgm_tail_bwd', dtype),
            label='B=%d C=%d %dx%d %s' % (B, C, H, H, 'fold+attw' if fold
                                          else 'attw, no fold'),
            form=None if fold else 'nofold',
            kernel=lambda: akgm.akgm_block_tail_backward_kernel(
                h, att, w, b, go, G, kw.get('norm_scale'),
                kw.get('norm_shift'), kw['attw']),
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
    # K8 and K9 in bf16 at the fp32 rows' shapes (the frame's levels) and
    # at the narrow widths on the frame's /8 level, from a generator of
    # their own
    g_tails = torch.Generator(dev).manual_seed(gen.initial_seed() + 18)
    for C, H, W in ([(C, H0 // s, W0 // s) for C, s in levels]
                    + [(C, h8, w8) for C in (8, 16, 32)]):
        tail_cases_bf16(C, H, W, gen=g_tails)
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
    # the forms an AKGM block at norm_groups > 1 runs, its GroupNorms apart
    # (K1 and K5 with attw and no fold, K2 and K6 with swish and no fold),
    # at the SID shapes of the folded cases, in float32 and in bf16, from a
    # generator of their own
    g25 = torch.Generator(dev).manual_seed(gen.initial_seed() + 25)
    for dtype in (f32, bf):
        for C, s in ((64, 1), (512, 8)):
            k1_case(C, H0 // s, W0 // s, gen=g25, dtype=dtype, fold=False)
        for label, H, W, cin, cout in (
                ('conv1 192->64 %dx%d swish, no fold' % (H0, W0), H0, W0,
                 192, 64),
                ('conv1 1024->512 %dx%d swish, no fold' % (h8, w8), h8, w8,
                 1024, 512)):
            conv_case(label, 1, H, W, cin, cout, act='swish', gen=g25,
                      dtype=dtype)
        for C, s in ((64, 1), (512, 8)):
            k5_case(C, T // s, gen=g25, dtype=dtype, fold=False)
        for label, H, cin, cout in (
                ('B=%d conv1 192->64 %dx%d swish, no fold' % (B, T, T), T,
                 192, 64),
                ('B=%d conv1 1024->512 %dx%d swish, no fold'
                 % (B, T // 8, T // 8), T // 8, 1024, 512)):
            conv_case(label, B, H, H, cin, cout, act='swish', backward=True,
                      gen=g25, gen_go=g25, dtype=dtype)
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
        # the plain version, or its float64 evaluation where a case gives
        # one, rounded to float32
        got = flat(case['kernel']())
        want = flat((case.get('reference') or case['plain'])())
        want = [w.float() if w.dtype == torch.float64 else w for w in want]
        torch.cuda.synchronize()
        # tolerances, float32 on both sides: a tensor output (the gradients
        # of K5 and K6 among them, whose weight, bias and attention parts
        # are sums over up to 0.66 M pixels, held against the plain version
        # in float64) within 1e-4 of max(1, its largest magnitude); (B, C)
        # sums and sums of squares
        # of up to 3.6 M values, added in another order (per pixel tile, then
        # over the tiles in a fixed order), within 1e-5 of the
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
        # the statistics of K1, K2 and K4, the weight and bias gradients of
        # K5 and K6, and K5's attention gradients are added in a fixed order:
        # a second call gives the same bits
        if case.get('fixed'):
            again = flat(case['kernel']())
            for i in case['fixed']:
                if not torch.equal(got[i], again[i]):
                    fail('%s %s: result %d differs between two calls'
                         % (name, label, i))
            del again
        del got, want
        err = errs[0]   # the first output's (gn1_stats: the sums')
        if case.get('form'):
            name = '%s %s' % (name, case['form'])
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


def build_model(seed, name=None, **unet):
    """The SID model (`name`: another diffusion variant) with random weights
    from `seed`, in eval()."""
    import torch
    from ucdir_tpu_torch.models.factory import define_G
    torch.manual_seed(seed)
    model = sid_model(**unet)
    if name is not None:
        model['diffusion_name'] = name
    return define_G({'model': model}).eval()


def injected(draws, d):
    """noise= for eval_step: the numpy draws in order, on device d."""
    import torch
    it = iter(draws)
    return lambda shape: torch.from_numpy(next(it)).to(d)


def agree(phase, what, got, want, tol=1e-5):
    """Fails unless two results of one function, float32 on both sides with
    sums in other orders (tiles, cuDNN, oneDNN) through ~70 layers and a
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
    # float32 on both sides, sums in other orders (tiles, cuDNN, oneDNN)
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


def train_opt(tmp, compute_dtype=None, model=None):
    """The SID train options of the `train` phases (`model`: other model
    options), checkpoints under `tmp`."""
    from ucdir_tpu_torch.configs import SID_MODEL
    return {'phase': 'train', 'model': copy.deepcopy(model or SID_MODEL),
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
    tensor-core core (`_build.TC_ENTRIES`: K1, K2, K3, K5, K6, K7, K8 and
    K9 in bf16) went through it, and no other entry point's did."""
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
    # each tail in bf16, card against host (bf16_slice's gate), the tail's
    # bf16 form BLOCKS times a step and no float32 kernel
    forms = {tail: 'akgm_%s_bf16' % k for tail, k in
             (('fused', 'tail'), ('mix', 'mix'), ('packed', 'packed'))}
    for tail, form in forms.items():
        host = build_model(seed, dropout=0.0, tail=tail)
        host.load_state_dict(weights, strict=True)
        card = copy.deepcopy(host).to(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        got = eval_step(card, make_schedule(sched_opt, dev),
                        torch.from_numpy(x).to(dev), noise=injected(draws, dev),
                        compute_dtype=torch.bfloat16)[0]
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t
        path = 'variants_%s_bf16' % tail
        n = counts[path] = dict(_build.LAUNCHES)
        TC[path] = _build.tc_launches()
        t = time.perf_counter()
        want = eval_step(host, make_schedule(sched_opt, 'cpu'),
                         torch.from_numpy(x), noise=injected(draws, 'cpu'),
                         compute_dtype=torch.bfloat16)[0]
        t_host = time.perf_counter() - t
        got = got.cpu()
        if (got.shape != want.shape or got.dtype != torch.float32
                or not torch.isfinite(got).all()):
            fail("variants: tail '%s' in bf16 gives shape %s, dtype %s or "
                 'non-finite values' % (tail, tuple(got.shape), got.dtype))
        d = (got - want).abs()
        mean = d.mean().item()
        if not mean <= 1e-3:
            fail("variants: tail '%s' in bf16 card vs host mean abs %.3e > "
                 '1e-3' % (tail, mean))
        expect = {'conv3x3_preact_bf16': steps, form: BLOCKS * steps}
        expect.update({f: 0 for f in forms.values() if f != form})
        wrong = {k: n[k] for k, v in expect.items() if n[k] != v}
        fp32 = [k for k, v in n.items() if v and not k.endswith('_bf16')]
        if wrong or fp32:
            fail("variants: tail '%s' in bf16 launched %s, expected %s; "
                 'float32 kernels launched: %s' % (tail, wrong, expect, fp32))
        tensor_cores_only(path, n)
        say('variants', "tail '%s' in bf16, dropout 0, full width, %dx%d, %d "
            'DDPM steps: card vs host mean abs %.3e (tol 1e-3), max abs '
            '%.3e; card %.2f s, host %.2f s; %s %d launches (%d a step), '
            'no float32 kernel' % (tail, size, size, steps, mean,
                                   d.max().item(), t_card, t_host, form,
                                   n[form], n[form] // steps))


def phase_tails_train_bf16(dev, seed, counts):
    """`train_bf16`'s steps under the 'mix' and 'packed' tails, two each
    (the first a warm-up): the forward through K8's or K9's bf16 form, BLOCKS
    launches a step, the backward through the autograd of their plain
    versions (the JAX package gives neither form a backward kernel); no
    float32 kernel, every tensor-core entry's launch through the tensor
    cores, masters and gradients float32."""
    import torch
    from ucdir_tpu_torch.configs import SID_MODEL
    from ucdir_tpu_torch.trainer import Trainer

    hr, lq = train_batch(seed)
    for tail in ('mix', 'packed'):
        model = copy.deepcopy(SID_MODEL)
        model['unet']['tail'] = tail
        path, form = 'train_bf16_' + tail, 'akgm_%s_bf16' % tail
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(train_opt(tmp, 'bf16', model), device=dev,
                              seed=seed)
            batch, secs, losses, again, peak, per_step, launches = \
                train_steps(dev, trainer, hr, lq, 2, path)
            counts[path] = per_step
            fp32 = [k for k, v in launches.items()
                    if v and not k.endswith('_bf16')]
            if per_step[form] != BLOCKS or fp32:
                fail('%s: %s launched %d times a step (expected %d), float32 '
                     'kernels launched %s' % (path, form, per_step[form],
                                              BLOCKS, fp32))
            tensor_cores_only(path, launches)
            params = list(trainer.model.parameters())
            if any(t.dtype != torch.float32 for t in params + [
                    p.grad for p in params if p.grad is not None]):
                fail('%s: a master weight or gradient is not float32' % path)
            say(path, "Trainer.optimize_parameters in bf16 under tail '%s', "
                'full width, crop %d (network %dx%d), batch %d, dropout '
                '0.1: %.3f s for the step after a warm-up, losses %s, the '
                'first step\'s draws again after %.6f, peak %.3f GiB; %s %d '
                'launches a step, the backward the autograd of the plain '
                'version; launches a step %s'
                % (tail, TRAIN_CROP, TRAIN_NET, TRAIN_NET, batch, secs,
                   json.dumps([round(v, 6) for v in losses]), again, peak,
                   form, per_step[form], json.dumps(per_step)))


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


# ---------------------------------------------------------------- phase 10b
RES_STEPS = 2                     # DDPM steps of the full-resolution frame
RES_SMALL = (200, 260)            # hires' small tiled case, H x W
RES_TILE = {'skip': 128, 'padding': 16}
GN_TILE = 64                      # UCDIR_TPU_GN_TILE of the gn_scope check


def full_frame_ddpm(dev, seed, model, frame, resident, compute_dtype=None,
                    steps=RES_STEPS):
    """The 2848 x 4256 frame through the validation step with `steps` DDPM
    steps on the resident path or the reassembling one (its draws from a
    generator seeded alike every call): (output, s per step with the
    predictor and the guide maps, peak GiB, launches)."""
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    model.resident = resident
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=steps), dev)
    gen = torch.Generator(dev).manual_seed(seed + 9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    sr, _ = eval_step(model, sched, frame, pad=PAD, generator=gen,
                      compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    n = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if sr.shape != frame.shape or not torch.isfinite(sr).all():
        fail('resident: output has shape %s or non-finite values'
             % (tuple(sr.shape),))
    return sr, secs / steps, peak, n


def small_case(seed):
    """hires' small tiled case: a 200 x 260 input and the draws of 2 DDPM
    steps and of 2 ddim steps, as numpy."""
    import numpy as np
    rng = np.random.default_rng(seed + 10)
    x = rng.uniform(-1, 1, (1,) + RES_SMALL + (3,)).astype(np.float32)
    shape = (1, RES_SMALL[0] + 2 * PAD, RES_SMALL[1] + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32) for _ in range(6)]
    return x, draws[:3], draws[3:]


def small_restorations(dev, seed, model, tile):
    """small_case through eval_step with `tile`: (DDPM 2 steps, ddim 2
    steps), each on the card, and the launches of the DDPM run."""
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    x, ddpm, ddim = small_case(seed)
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=2), dev)
    x = torch.from_numpy(x).to(dev)
    _build.reset_launches()
    a = eval_step(model, sched, x, noise=injected(ddpm, dev), tile=tile)[0]
    n = dict(_build.LAUNCHES)
    b = eval_step(model, sched, x, noise=injected(ddim, dev), tile=tile,
                  sampler='ddim', sampling_timesteps=2)[0]
    torch.cuda.synchronize()
    return a, b, n


def resident_worker(job_path):
    """One rank of the resident phase (`--resident_worker <job.json>`, a
    subprocess; torchrun's variables in the environment): small_case with
    its tiles over the ranks, DDPM on the resident path and ddim tiled.
    Writes rank<r>.pt (both outputs) and rank<r>.json."""
    import torch
    from ucdir_tpu_torch.utils.dist import exit_dist, get_dist_info, init_dist

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_dist('pytorch', backend=job['backend'], device='cuda')
    rank, world = get_dist_info()
    model = build_model(job['seed'], dropout=0.0).to(dev)
    t = time.perf_counter()
    a, b, n = small_restorations(dev, job['seed'], model, dict(
        RES_TILE, tile_chunk=world, distributed=True))
    secs = time.perf_counter() - t
    torch.save({'ddpm': a.cpu(), 'ddim': b.cpu()},
               os.path.join(job['out'], 'rank%d.pt' % rank))
    with open(os.path.join(job['out'], 'rank%d.json' % rank), 'w') as f:
        json.dump({'rank': rank, 'world': world, 'device': str(dev),
                   'secs': secs, 'launches': n}, f)
    exit_dist()
    return 0


def ranks_against_one(dev, seed, one, backend, ranks):
    """small_case over `ranks` ranks (subprocesses, `backend`) against one
    process's (DDPM, ddim): fails unless every rank has its bits. Returns
    the ranks' json."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks({'seed': seed, 'backend': backend, 'out': tmp},
                         tmp, ranks, worker='--resident_worker')
        got = [torch.load(os.path.join(tmp, 'rank%d.pt' % r),
                          weights_only=True) for r in range(ranks)]
    for r, g in enumerate(got):
        for k, want in zip(('ddpm', 'ddim'), one):
            if not torch.equal(g[k], want.cpu()):
                fail('resident: %s, rank %d of %d (%s): %s not the bits of '
                     'one process, max abs diff %.3e'
                     % (k, r, ranks, backend, k,
                        (g[k] - want.cpu()).abs().max().item()))
    return outs


def phase_resident(dev, seed, counts):
    """The tile-resident reverse process: the full-resolution frame on the
    resident path against the reassembling one, one image's tiles over
    ranks, and the tile-scoped GroupNorm."""
    import torch
    import torch.distributed as dist
    from ucdir_tpu_torch.parallel.resident import ResidentPlan

    model = build_model(seed, dropout=0.0).to(dev)

    # 1. the full-resolution frame, DDPM, resident against reassembling
    gen = torch.Generator(dev).manual_seed(seed + 8)
    frame = torch.rand((1,) + FULL_FRAME + (3,), generator=gen,
                       device=dev) * 2 - 1
    plan = ResidentPlan(FULL_FRAME[0] + 2 * PAD, FULL_FRAME[1] + 2 * PAD,
                        TILE, PAD)
    # once each (the frame's ddim in `hires` has warmed the card at this
    # size): the reassembling path, then the resident one
    runs = []
    for resident in (False, True):
        out, secs, peak, n = full_frame_ddpm(dev, seed, model, frame,
                                             resident)
        # to the host, so that no run's peak holds another's output
        runs.append((out.cpu(), secs, peak, n))
        del out
    res = runs[1][0]
    n = counts['resident'] = runs[1][3]
    launched('resident', n, FORWARD, None)
    if n['conv3x3_preact'] != plan.n_tiles * RES_STEPS:
        fail('resident: %d windows, %d steps, %d head launches'
             % (plan.n_tiles, RES_STEPS, n['conv3x3_preact']))
    same = torch.equal(runs[0][0], res)
    diff = (runs[0][0] - res).abs().max().item()
    say('resident', 'frame %dx%d, DDPM %d steps, %d windows of %d (%d '
        'owning pixels), %d copies a step: reassembling %.3f, resident '
        '%.3f s per step (the predictor and the guide maps in each), peak '
        '%.3f against %.3f GiB; the same bits: %s (max abs diff %.3e); '
        'launches %s'
        % (FULL_FRAME + (RES_STEPS, plan.n_tiles, TILE, len(plan.owned),
                         len(plan.copies), runs[0][1], runs[1][1],
                         runs[0][2], runs[1][2], same, diff,
                         json.dumps(n))))
    del runs
    if not same:
        fail('resident: the full-resolution frame is not the reassembling '
             'path\'s bits (max abs diff %.3e)' % diff)
    # bf16's gate: within 0.05 mean abs of the float32 frame
    r16, t16, p16, n16 = full_frame_ddpm(dev, seed, model, frame, True,
                                         torch.bfloat16)
    launched('resident', n16, FORWARD, 'bf16')
    d16 = (r16.cpu() - res).abs().mean().item()
    del res, r16
    if not d16 < 0.05:
        fail('resident: the bf16 frame is %.3e mean abs from float32\'s'
             % d16)
    say('resident', 'the same frame in bf16 on the resident path, DDPM %d '
        'steps: %.3f s per step, peak %.3f GiB, %.3e mean abs from the '
        'float32 frame (tol 0.05)' % (RES_STEPS, t16, p16, d16))
    model.resident = True
    del frame
    torch.cuda.empty_cache()

    # 2. small_case (hires' small case holds the resident path card against
    # host): one process, twice, then two gloo ranks sharing the card
    one = small_restorations(dev, seed, model, dict(RES_TILE))
    again = small_restorations(dev, seed, model, dict(RES_TILE))
    for k, a, b in zip(('DDPM', 'ddim'), one[:2], again[:2]):
        if not torch.equal(a, b):
            fail('resident: %s tiled, a second run on the card is not the '
                 'first one\'s bits' % k)
    say('resident', '%dx%d, tiles %s, DDPM (resident) and ddim (tiled) 2 '
        'steps, one process: a second run the same bits'
        % (RES_SMALL + (json.dumps(RES_TILE),)))
    outs = ranks_against_one(dev, seed, one[:2], 'gloo', 2)
    say('resident', '2 gloo ranks sharing the card (%s), the image\'s tiles '
        'over them: DDPM (resident) and ddim (tiled) the bits of one '
        'process on every rank; s per rank %s'
        % (' '.join(r['device'] for r in outs),
           ' '.join('%.3f' % r['secs'] for r in outs)))

    # 3. one NCCL rank through the same code: a group of one runs the
    # group's branches, so the geometry's all_reduce, the resident path's
    # final all_gather and the tiled path's all_gather a step go through
    # NCCL on the card; the exchange has no peer (NCCL takes one rank a
    # card, so its batch_isend_irecv needs two cards)
    calls = []
    real = {k: getattr(dist, k) for k in ('all_reduce', 'all_gather',
                                          'batch_isend_irecv')}

    def counted(name):
        def call(*args, **kwargs):
            calls.append(name)
            return real[name](*args, **kwargs)
        return call

    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d'
                            % free_port(), rank=0, world_size=1)
    try:
        for k in real:
            setattr(dist, k, counted(k))
        nccl = small_restorations(dev, seed, model, dict(
            RES_TILE, tile_chunk=1, distributed=True))
    finally:
        for k, f in real.items():
            setattr(dist, k, f)
        dist.destroy_process_group()
    for k, a, b in zip(('DDPM', 'ddim'), nccl[:2], one[:2]):
        if not torch.equal(a, b):
            fail('resident: %s on one NCCL rank is not one process\'s bits'
                 % k)
    # DDPM (resident): all_reduce, then all_gather; ddim: all_gather a step
    want = ['all_reduce', 'all_gather'] + ['all_gather'] * 2
    if calls != want:
        fail('resident: one NCCL rank issued %s, not %s' % (calls, want))
    say('resident', 'one NCCL rank: DDPM and ddim the bits of one process; '
        'NCCL collectives on the card: %s; the p2p exchange not run (no '
        'peer on a group of one)' % ' '.join(calls))

    # 4. NCCL over every card
    cards = torch.cuda.device_count()
    if cards >= 2:
        outs = ranks_against_one(dev, seed, one[:2], 'nccl', cards)
        say('resident', 'NCCL over %d cards: DDPM and ddim the bits of one '
            'process on every rank; s per rank %s'
            % (cards, ' '.join('%.3f' % r['secs'] for r in outs)))
    else:
        say('resident', 'NCCL over several cards: not run, this machine '
            'has %d card' % cards)
    del one, again, nccl

    # 5. the tile-scoped GroupNorm
    gn_scope_check(dev, seed)


def gn_scope_check(dev, seed):
    """UCDIR_TPU_GN_SCOPE=tile: card against host at 200 x 260 with
    64-px windows (2 DDPM steps, the K2 nofold+swish and K1 nofold forms
    launched); ms per DY3h step on the SID frame, canvas against tile
    scope, float32 and bf16, each a 3-step frame less a 1-step one."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    env = {k: os.environ.get(k) for k in ('UCDIR_TPU_GN_SCOPE',
                                          'UCDIR_TPU_GN_TILE')}
    os.environ.update(UCDIR_TPU_GN_SCOPE='tile',
                      UCDIR_TPU_GN_TILE=str(GN_TILE))
    try:
        host = build_model(seed, dropout=0.0)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (host.denoise_fn.gn_scope, host.denoise_fn.gn_tile) != ('tile',
                                                               GN_TILE):
        fail('gn_scope: define_G did not read the switches')
    model = copy.deepcopy(host).to(dev)
    rng = np.random.default_rng(seed + 11)
    x = rng.uniform(-1, 1, (1,) + RES_SMALL + (3,)).astype(np.float32)
    shape = (1, RES_SMALL[0] + 2 * PAD, RES_SMALL[1] + 2 * PAD, 3)
    draws = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=2)
    _build.reset_launches()
    got = eval_step(model, make_schedule(sched_opt, dev),
                    torch.from_numpy(x).to(dev),
                    noise=injected(draws, dev))[0]
    forms = dict(_build.FORMS)
    want = eval_step(host, make_schedule(sched_opt, 'cpu'),
                     torch.from_numpy(x), noise=injected(draws, 'cpu'))[0]
    err = agree('gn_scope', 'tile scope card vs host', got, want)
    for form in ('conv3x3 nofold+swish', 'akgm_tail nofold'):
        if not forms.get(form):
            fail('gn_scope: %s never launched: %s' % (form, forms))
    model.denoise_fn.gn_scope = 'canvas'
    base = eval_step(model, make_schedule(sched_opt, dev),
                     torch.from_numpy(x).to(dev),
                     noise=injected(draws, dev))[0]
    say('gn_scope', 'UCDIR_TPU_GN_SCOPE=tile, UCDIR_TPU_GN_TILE=%d, %dx%d, '
        '2 DDPM steps: card vs host max abs err %.3e (tol 1e-5), %.3e from '
        'the canvas scope; forms %s'
        % ((GN_TILE,) + RES_SMALL + (err, (got - base).abs().max().item(),
                                     json.dumps(forms))))
    del host, got, want, base

    # ms per DY3h step on the SID frame (1024-px windows): a 3-step frame
    # less a 1-step one, so that what a frame does once (the cast to bf16
    # inside eval_step, the predictor, the guide maps, the pads) drops out
    model.denoise_fn.gn_tile = 1024
    gen = torch.Generator(dev).manual_seed(seed)
    frame = torch.rand((1,) + SID_FRAME + (3,), generator=gen,
                       device=dev) * 2 - 1
    line = []
    for dtype in (None, torch.bfloat16):
        for scope in ('canvas', 'tile'):
            model.denoise_fn.gn_scope = scope
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
            secs = {}
            for steps in (1, 3):
                sched = make_schedule(dict(SID_VAL_SCHEDULE,
                                           n_timestep=steps), dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                sr = eval_step(model, sched, frame, pad=PAD, generator=gen,
                               compute_dtype=dtype)[0]
                torch.cuda.synchronize()
                secs[steps] = time.perf_counter() - t
                if not torch.isfinite(sr).all():
                    fail('gn_scope: %s scope frame not finite' % scope)
            step = (secs[3] - secs[1]) / 2
            line.append('%s %s %.1f ms (once a frame %.1f ms, peak %.3f '
                        'GiB, %s)' % (
                            'bf16' if dtype else 'fp32', scope, 1e3 * step,
                            1e3 * (secs[1] - step),
                            torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                            json.dumps(dict(_build.FORMS))))
    say('gn_scope', 'frame %dx%d (network %dx%d), ms per DY3h step (a '
        '3-step frame less a 1-step one): %s'
        % (SID_FRAME + NET_FRAME + ('; '.join(line),)))

# ------------------------------------------------------------ phases 11-12
# K1..K4, the forward kernels of the validation path, and K5, K6
FORWARD = ('akgm_tail', 'conv3x3', 'conv1x1', 'gn1_stats')
TRAIN = FORWARD + ('akgm_tail_bwd', 'conv3x3_bwd')


def launched(phase, launches, names, compute_dtype):
    """Fails unless each kernel of `names` (in `compute_dtype`'s form)
    launched."""
    sfx = '' if compute_dtype is None else '_bf16'
    missing = [k + sfx for k in names if launches[k + sfx] == 0]
    if missing:
        fail('%s: kernels never launched: %s' % (phase, missing))


def task_opt(task, compute_dtype=None):
    """The options `sr.py -p val -c ucdir_tpu/configs/<task>.yaml` runs:
    the port's config.parse (its per-task validation overrides: 50 steps,
    linear_end 0.4), random weights, `compute_dtype`."""
    from ucdir_tpu_torch import config
    opt = config.parse(os.path.join(ROOT, 'ucdir_tpu', 'configs',
                                    task + '.yaml'), phase='val',
                       make_dirs=False)
    sched = opt['model']['beta_schedule']['val']
    if (sched['n_timestep'], sched['linear_end']) != (50, 0.4):
        fail('tasks: config.parse set %s for %s' % (sched, task))
    opt['compute_dtype'] = compute_dtype
    return opt


def task_frame(dev, seed, task, hr, lq, compute_dtype=None, steps=None):
    """Trainer.test on one frame of `task` (create_model, feed_data, test),
    on the schedule config.parse sets, or its first `steps` steps as the
    `sid` phase runs them (a schedule of `steps`). Returns the launches."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.metrics import core as Metrics
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import create_model

    opt = task_opt(task, compute_dtype)
    torch.manual_seed(seed)
    trainer = create_model(opt, device=dev, seed=seed)
    if steps is not None:
        trainer.set_new_noise_schedule(
            dict(opt['model']['beta_schedule']['val'], n_timestep=steps),
            'val', force=True)
    steps = trainer.schedules['val'].num_timesteps
    trainer.feed_data({'SR': lq, 'HR': hr})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    trainer.test(continous=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    sr = trainer.get_current_visuals()['SR']
    if sr.shape != hr.shape or not np.isfinite(sr).all():
        fail('tasks: %s output has shape %s or non-finite values'
             % (task, sr.shape))
    launched('tasks', launches, FORWARD, compute_dtype)
    psnr = Metrics.calculate_psnr(Metrics.tensor2img(sr[0]),
                                  Metrics.tensor2img(hr[0]))
    say('tasks', '%s, frame %dx%d, %d steps%s, full width: %.3f s per '
        'frame, %.1f ms per step (the predictor and the guide maps '
        'included), PSNR %.4f dB (random weights), peak %.3f GiB, launches %s'
        % ((task,) + hr.shape[1:3] + (
            steps, '' if compute_dtype is None else ' in ' + compute_dtype,
            secs, 1e3 * secs / steps, psnr, peak, json.dumps(launches))))
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_tasks(dev, seed, counts):
    """The gop-deblur and jpg-restore configurations through the validation
    entry points: one GoPro frame, 10 steps; one Imagenet frame after the
    /16 crop, JPEG at quality 10 (config.parse's jpg- factor) by the port's
    DiffJPEG, 50 steps, in float32 and in bf16."""
    import torch
    from ucdir_tpu_torch.data.diffjpeg import diff_jpeg

    hr, lq = pattern(*GOPRO_FRAME, seed + 9)
    counts['tasks_gop'] = task_frame(dev, seed, 'gop-deblur', hr, lq,
                                     steps=TASK_STEPS)
    hr, _ = pattern(*JPEG_FRAME, seed + 10)
    with torch.no_grad():
        hr01 = (torch.from_numpy(hr).to(dev) + 1) / 2
        lq = (diff_jpeg(hr01, JPEG_QUALITY, differentiable=False) * 2 - 1
              ).cpu().numpy()
    for dtype in (None, 'bf16'):
        counts['tasks_jpg' + ('' if dtype is None else '_bf16')] = \
            task_frame(dev, seed, 'jpg-restore', hr, lq, dtype)


def realsr_images(seed, n):
    """`n` generated REALSR_CROP x REALSR_CROP images, HWC float32 in
    [0, 1]: smooth colour fields with texture."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:REALSR_CROP, 0:REALSR_CROP] / (REALSR_CROP - 1.0)
    out = []
    for i in range(n):
        img = np.stack([np.sin((2 + i) * xx + c) * np.cos((3 + i) * yy - c)
                        for c in range(3)], -1) * 0.4 + 0.5
        img += rng.normal(0, 0.05, img.shape)
        out.append(np.clip(img, 0, 1).astype(np.float32))
    return out


def realsr_batches(ds, images, feeds):
    """`feeds` batches of RealESRGANDataset items made from `images` (its
    flips, crop and kernel draws; no file read), collated as the loader
    does."""
    import numpy as np
    out = []
    for _ in range(feeds):
        items = [ds.from_image(img, i) for i, img in enumerate(images)]
        out.append({k: np.stack([it[k] for it in items])
                    for k in ('gt', 'kernel1', 'kernel2', 'sinc_kernel')})
    return out


def realsr_trainer(dev, seed, tmp, compute_dtype=None, **unet):
    """A DDPM_realsr trainer (the SID model, or `unet` overrides) with the
    `dopt` preset, through create_model."""
    import torch
    from ucdir_tpu_torch.trainer import create_model
    opt = train_opt(tmp, compute_dtype)
    opt['model']['name'] = 'DDPM_realsr'
    opt['model']['unet'].update(unet)
    opt['dopt'] = 'dopt'
    torch.manual_seed(seed)
    return create_model(opt, device=dev, seed=seed)


def realsr_steps(dev, seed, tmp, batches, steps, compute_dtype=None):
    """Feeds every batch, and after each of the last `steps` feeds one
    optimize_parameters (the first a warm-up). Returns (ms per feed, s per
    step, losses, peak GiB, the launches of the timed steps)."""
    import torch
    from ucdir_tpu_torch.ops import _build

    trainer = realsr_trainer(dev, seed, tmp, compute_dtype)
    feed_ms, step_s, losses = [], [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.feed_data(batch)
        torch.cuda.synchronize()
        feed_ms.append(1e3 * (time.perf_counter() - t))
        sr = trainer.data['SR']
        if (not torch.is_tensor(sr) or sr.device != dev
                or tuple(sr.shape) != (REALSR_BATCH, 256, 256, 3)):
            fail('realsr: feed %d gave SR %s' % (i, type(sr)))
        if i < len(batches) - steps:
            continue
        if i == len(batches) - steps + 1:
            _build.reset_launches()   # after the warm-up step
        t = time.perf_counter()
        trainer.optimize_parameters()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(trainer.get_current_log()['l_pix'])
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not all(math.isfinite(l) for l in losses):
        fail('realsr: non-finite loss in %s' % losses)
    launched('realsr', launches, TRAIN, compute_dtype)
    queue = trainer.queue_ptr
    del trainer
    torch.cuda.empty_cache()
    return feed_ms, step_s[1:], losses, peak, launches, queue


def phase_realsr(dev, seed, counts):
    """DDPM_realsr at the SID model's full width: Real-ESRGAN's batch 12,
    400 x 400 dataset crops, gt_size 256, a queue of 180, the `dopt`
    preset; 16 feeds (15 fill the queue, the 16th swaps) with a step after
    each of the last 4, then 4 feeds and steps in bf16; the USM filter's
    time; the feed card against host at a small size."""
    import random
    import statistics
    import numpy as np
    import torch
    from ucdir_tpu_torch.data.degradations import usm_sharp
    from ucdir_tpu_torch.realsr import RealESRGANDataset, feed_agreement

    with tempfile.TemporaryDirectory() as tmp:
        txt = os.path.join(tmp, 'list.txt')
        with open(txt, 'w') as f:
            f.write('\n'.join('%d.png' % i for i in range(REALSR_BATCH)))
        ds = RealESRGANDataset({'root': tmp, 'txt': txt}, split='train',
                               crop_size=REALSR_CROP)
        images = realsr_images(seed + 11, REALSR_BATCH)
        random.seed(seed), np.random.seed(seed)
        batches = realsr_batches(ds, images, REALSR_FEEDS)
        for dtype, n_feeds in ((None, REALSR_FEEDS), ('bf16', REALSR_STEPS)):
            feed_ms, step_s, losses, peak, launches, queue = realsr_steps(
                dev, seed, tmp, batches[:n_feeds], REALSR_STEPS, dtype)
            counts['realsr' + ('' if dtype is None else '_bf16')] = launches
            say('realsr', 'DDPM_realsr%s, full width, batch %d, dataset crop '
                '%d, gt_size 256, queue %d of 180 filled: %d feeds, median '
                '%.1f ms per feed (%s); %.3f s per optimizer step (mean of '
                '%d after a warm-up), losses %s, peak %.3f GiB, launches of '
                'the timed steps %s'
                % ('' if dtype is None else ' in bf16', REALSR_BATCH,
                   REALSR_CROP, queue, n_feeds, statistics.median(feed_ms),
                   ' '.join('%.1f' % v for v in feed_ms),
                   sum(step_s) / len(step_s), len(step_s),
                   json.dumps([round(l, 6) for l in losses]), peak,
                   json.dumps(launches)))

        # the sharpening filter alone: the feed's (radius 15) and the
        # reference USMSharp's default (radius 50, a 51 x 51 filter)
        gt = torch.from_numpy(batches[0]['gt']).to(dev)
        for radius in (15, 50):
            usm_sharp(gt, radius=radius)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                usm_sharp(gt, radius=radius)
            torch.cuda.synchronize()
            say('realsr', 'usm_sharp radius %d (%d x %d filter) on %d x %d x '
                '%d x 3: %.3f ms' % (radius, radius | 1, radius | 1,
                                     REALSR_BATCH, REALSR_CROP, REALSR_CROP,
                                     1e3 * (time.perf_counter() - t) / 5))
        del gt, batches

        # the feed on the card and on the host: 2 images, crop 128, gt_size
        # 64, a queue of 4 (3 feeds: two fill it, one swaps), the same coins
        # and the host's per-sample draws replayed on the card
        small = RealESRGANDataset({'root': tmp, 'txt': txt}, split='train',
                                  crop_size=128)
        images = [img[:128, :128] for img in images[:2]]
        random.seed(seed + 1), np.random.seed(seed + 1)
        batches = realsr_batches(small, images, 3)
        feeds, tape = {}, []

        def record(name, img, make):
            d = make()
            tape.append((name, d))
            return d

        def replay(name, img, make):
            was, d = tape.pop(0)
            if was != name:
                fail('realsr: the card drew at %s, the host at %s'
                     % (name, was))
            return {k: v.to(img.device) for k, v in d.items()}

        for d, draws in (('cpu', record), (dev, replay)):
            trainer = realsr_trainer(d, seed, tmp, inner_channel=8,
                                     channel_mults=[1, 2], attn_res=[],
                                     res_blocks=1)
            trainer.dopt = dict(trainer.dopt, gt_size=64, queue_size=4)
            trainer.queue_size = 4
            random.seed(seed + 2), np.random.seed(seed + 2)
            feeds[str(d)] = []
            for batch in batches:
                trainer.feed_data(batch, draws=draws)
                feeds[str(d)].append(dict(trainer.data))
        for i, (card, host) in enumerate(zip(feeds[str(dev)], feeds['cpu'])):
            a = feed_agreement(card, host)
            if not a['ok']:
                fail('realsr: feed %d card vs host outside the feed limit: %s'
                     % (i, a))
            say('realsr', 'feed %d (%s), 2 x 128 x 128 -> gt_size 64, card vs '
                'host: HR max abs %.3e (limit 1e-4), SR mean abs %.3e (limit '
                '1e-3), %.5f of SR on the same 1/255 level (limit 0.99), SR '
                'max abs %.3e' % (i, 'fills the queue' if i < 2 else 'swaps',
                                  a['hr_max_abs'], a['sr_mean_abs'],
                                  a['sr_same_level'], a['sr_max_abs']))


# ---------------------------------------------------------------- phase 13
def per_image_noise(dev, seed, shape, n, images):
    """For each of `images` images, `n` standard normal draws of one
    image's `shape` (1, H, W, 3) on the card, from a generator of its own:
    the same draws whatever batch the image is restored in."""
    import torch
    out = []
    for j in range(images):
        gen = torch.Generator(dev).manual_seed(seed * 1000 + j)
        out.append([torch.randn(shape, generator=gen, device=dev)
                    for _ in range(n)])
    return out


def stacked(draws, images):
    """noise= for Trainer.test: at the k-th call, draw k of each image of
    `images`, stacked in that order on the batch axis."""
    import torch
    k = iter(range(len(draws[0])))

    def noise(shape):
        i = next(k)
        out = torch.cat([draws[j][i] for j in images])
        if tuple(out.shape) != tuple(shape):
            fail('dist: the sampler drew %s, the images have %s'
                 % (tuple(shape), tuple(out.shape)))
        return out
    return noise


def val_batch_agreement(dev, seed, counts, compute_dtype):
    """The jpg-restore model (phase 11's) on VAL_BATCH 368 x 496 JPEG
    frames, TASK_STEPS steps: Trainer.test on the batch, then on each image
    alone, each image with the same injected draws; fails unless every image
    agrees with its batch-1 restoration (float32 1e-5 max abs, bf16 1e-3
    mean abs) and every forward kernel (bf16: through the tensor cores, as
    at batch 1) launched at the batch."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.data.diffjpeg import diff_jpeg
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import create_model

    opt = task_opt('jpg-restore', compute_dtype)
    torch.manual_seed(seed)
    trainer = create_model(opt, device=dev, seed=seed)
    trainer.set_new_noise_schedule(
        dict(opt['model']['beta_schedule']['val'], n_timestep=TASK_STEPS),
        'val', force=True)
    hr = np.concatenate([pattern(*JPEG_FRAME, seed + 30 + j)[0]
                         for j in range(VAL_BATCH)])
    with torch.no_grad():
        lq = (diff_jpeg((torch.from_numpy(hr).to(dev) + 1) / 2, JPEG_QUALITY,
                        differentiable=False) * 2 - 1).cpu().numpy()
    shape = (1, JPEG_FRAME[0] + 2 * PAD, JPEG_FRAME[1] + 2 * PAD, 3)
    draws = per_image_noise(dev, seed + 30, shape, TASK_STEPS + 1, VAL_BATCH)
    path = 'dist_valbatch' + ('' if compute_dtype is None else '_bf16')

    def restore(images):
        trainer.feed_data({'SR': lq[images], 'HR': hr[images]})
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.test(continous=True, noise=stacked(draws, images))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        sr = trainer.get_current_visuals()['SR'][-1]
        return sr.reshape((len(images),) + sr.shape[-3:]), secs

    one = [restore([j]) for j in range(VAL_BATCH)]
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    batch, secs = restore(list(range(VAL_BATCH)))
    counts[path] = dict(_build.LAUNCHES)
    TC[path] = _build.tc_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launched(path, counts[path], FORWARD, compute_dtype)
    if compute_dtype is not None:
        tensor_cores_only(path, counts[path])
    errs = []
    for j, (sr1, _) in enumerate(one):
        got = batch[j]
        if got.shape != sr1[0].shape or not np.isfinite(got).all():
            fail('dist: image %d of the batch has shape %s or non-finite '
                 'values' % (j, got.shape))
        d = np.abs(got.astype(np.float64) - sr1[0])
        errs.append(d.mean() if compute_dtype else d.max())
    tol = 1e-3 if compute_dtype else 1e-5
    if not max(errs) <= tol:
        fail('dist: %s, batch %d against batch 1: %s abs %s > %.0e'
             % (compute_dtype or 'float32', VAL_BATCH,
                'mean' if compute_dtype else 'max', errs, tol))
    t1 = sum(s for _, s in one) / VAL_BATCH
    say('dist', 'val_batch: jpg-restore, %d frames %dx%d (network %dx%d), '
        '%d steps%s, full width, each with its own injected draws: batch %d '
        'against each image alone, per image %s abs %s (tol %.0e); s per '
        'image %.3f at batch 1, %.3f at batch %d (ms per step per image '
        '%.2f, %.2f); peak at batch %d %.3f GiB; launches at batch %d %s'
        % (VAL_BATCH, JPEG_FRAME[0], JPEG_FRAME[1], -(-shape[1] // 32) * 32,
           -(-shape[2] // 32) * 32, TASK_STEPS,
           '' if compute_dtype is None else ' in ' + compute_dtype,
           VAL_BATCH, 'mean' if compute_dtype else 'max',
           ' '.join('%.3e' % e for e in errs), tol, t1, secs / VAL_BATCH,
           VAL_BATCH, 1e3 * t1 / TASK_STEPS,
           1e3 * secs / VAL_BATCH / TASK_STEPS, VAL_BATCH, peak, VAL_BATCH,
           json.dumps(counts[path])))
    del trainer, draws
    torch.cuda.empty_cache()


def sid_batch(dev, seed, counts):
    """SID_BATCH SID frames in one Trainer.test, SID_STEPS steps, float32
    and bf16: s per image (phase `sid` and `bf16` give batch 1), peak."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import Trainer

    rng = np.random.default_rng(seed + 40)
    lq = rng.uniform(-1, 1, (SID_BATCH,) + SID_FRAME + (3,)).astype(
        np.float32)
    for dtype in (None, 'bf16'):
        opt = {'phase': 'val', 'model': sid_model(), 'compute_dtype': dtype,
               'path': {'resume_state': None},
               'train': {'ema_scheduler': {'use': True}}}
        torch.manual_seed(seed)
        trainer = Trainer(opt, device=dev, seed=seed)
        trainer.set_new_noise_schedule(
            dict(opt['model']['beta_schedule']['val'], n_timestep=SID_STEPS),
            'val', force=True)
        trainer.feed_data({'SR': lq, 'HR': lq})
        path = 'dist_sid' + ('' if dtype is None else '_bf16')
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        trainer.test(continous=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts[path] = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        sr = trainer.get_current_visuals()['SR']
        if sr.shape != lq.shape or not np.isfinite(sr).all():
            fail('dist: SID batch output has shape %s or non-finite values'
                 % (sr.shape,))
        launched(path, counts[path], FORWARD, dtype)
        say('dist', 'val_batch: SID frames %dx%d, batch %d, %d steps%s: %.3f '
            's per image (%.1f ms per step per image), peak %.3f GiB, '
            'launches %s' % (SID_FRAME + (SID_BATCH, SID_STEPS,
                                          '' if dtype is None else ' in bf16',
                                          secs / SID_BATCH,
                                          1e3 * secs / SID_BATCH / SID_STEPS,
                                          peak, json.dumps(counts[path]))))
        del trainer
        torch.cuda.empty_cache()


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def train_state(trainer):
    """The trainer's parameters, EMA shadow and AdamW state, in a fixed
    order."""
    import torch
    state = trainer.state
    params = [p for _, p in trainer.model.named_parameters()]
    return (params, [state.ema_params[k] for k in sorted(state.ema_params)],
            [v for p in params for _, v in
             sorted(state.optimizer.state.get(p, {}).items())
             if torch.is_tensor(v)])


def ddp_worker(job_path):
    """One rank of the data-parallel steps (`--ddp_worker <job.json>`, a
    subprocess of phase_dist; torchrun's variables in the environment): the
    SID train Trainer on its rows (job['batch'] a rank) of the global batch,
    DDP_STEPS steps.
    Writes rank<r>.json (losses, step times, launches, the digests of its
    parameters, EMA and AdamW state) and, on rank 0, the parameters."""
    import torch
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import Trainer
    from ucdir_tpu_torch.utils.dist import exit_dist, get_dist_info, init_dist

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_dist('pytorch', backend=job['backend'], device='cuda')
    rank, world = get_dist_info()
    hr, lq = train_batch(job['seed'])
    rows = slice(rank * job['batch'], (rank + 1) * job['batch'])
    # each rank builds other weights: the trainer starts from rank 0's
    torch.manual_seed(job['seed'] + rank)
    trainer = Trainer(train_opt(job['out'], job['dtype']), device=dev,
                      seed=job['seed'])
    torch.cuda.synchronize()
    _build.reset_launches()
    losses, secs = [], []
    for _ in range(DDP_STEPS):
        trainer.feed_data({'HR': hr[rows], 'SR': lq[rows]})
        t = time.perf_counter()
        trainer.optimize_parameters()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(trainer.get_current_log()['l_pix'])
    launches, tc = dict(_build.LAUNCHES), _build.tc_launches()
    params, ema, adam = train_state(trainer)
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    trainer.model.state_dict().items()},
                   os.path.join(job['out'], 'params.pt'))
    with open(os.path.join(job['out'], 'rank%d.json' % rank), 'w') as f:
        json.dump({'rank': rank, 'world': world, 'device': str(dev),
                   'trainer_world': trainer.world_size, 'losses': losses,
                   'secs': secs, 'launches': launches, 'tc': tc,
                   'digests': [_digest(params), _digest(ema),
                               _digest(adam)]}, f)
    exit_dist()
    return 0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(job, tmp, ranks, worker='--ddp_worker'):
    """Runs `ranks` processes of this script's `worker` (ddp_worker, or
    resident_worker) on `job`; fails unless each ends with 0 within 600 s.
    Returns their rank<r>.json."""
    path = os.path.join(tmp, 'job.json')
    with open(path, 'w') as f:
        json.dump(job, f)
    port = free_port()
    procs = []
    try:
        for r in range(ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                       LOCAL_RANK=str(r), MASTER_ADDR='127.0.0.1',
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), worker,
                 path], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for r, p in enumerate(procs):
            out = p.communicate(timeout=600)[0]
            if p.returncode != 0:
                fail('dist: rank %d exited with %d:\n%s'
                     % (r, p.returncode, out[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r in range(ranks):
        with open(os.path.join(tmp, 'rank%d.json' % r)) as f:
            out.append(json.load(f))
    return out


def nccl_one_rank(dev, trainer):
    """all_reduce_mean_ on a one-rank NCCL group over the gradients of the
    trainer's last step: fails unless every bit stays."""
    import torch
    import torch.distributed as dist
    from ucdir_tpu_torch.parallel.mesh import all_reduce_mean_

    grads = [p.grad for p in trainer.model.parameters()
             if p.grad is not None]
    before = [g.clone() for g in grads]
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d'
                            % free_port(), rank=0, world_size=1)
    try:
        all_reduce_mean_(grads)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    changed = sum(not torch.equal(a, b) for a, b in zip(grads, before))
    if changed or not grads:
        fail('dist: all_reduce_mean_ on one NCCL rank changed %d of %d '
             'gradients' % (changed, len(grads)))
    say('dist', 'ddp: all_reduce_mean_ on a one-rank NCCL group over the '
        'float32 step\'s %d gradients (%d values): every bit kept'
        % (len(grads), sum(g.numel() for g in grads)))


def ddp(dev, seed, counts, compute_dtype, ranks=DDP_RANKS, batch=DDP_BATCH):
    """`ranks` ranks, `batch` images each, against one process on the
    global batch, DDP_STEPS steps of the SID train Trainer (crop 256,
    dropout 0.1): the losses (float32 1e-5 rel, bf16 1e-3), the parameters
    after (float32 4.04e-4, bf16 2 * lr a step), the ranks' parameters, EMA
    and AdamW state bit for bit."""
    import torch
    from ucdir_tpu_torch.trainer import Trainer

    backend = 'nccl' if torch.cuda.device_count() >= ranks else 'gloo'
    hr, lq = train_batch(seed)
    n = ranks * batch
    path = 'dist_ddp' + ('' if compute_dtype is None else '_bf16')
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(seed)
        one = Trainer(train_opt(tmp, compute_dtype), device=dev, seed=seed)
        losses = []
        for _ in range(DDP_STEPS):
            one.feed_data({'HR': hr[:n], 'SR': lq[:n]})
            one.optimize_parameters()
            losses.append(one.get_current_log()['l_pix'])
        if compute_dtype is None:
            nccl_one_rank(dev, one)
        want = {k: v.detach().cpu()
                for k, v in one.model.state_dict().items()}
        del one
        torch.cuda.empty_cache()
        outs = run_ranks({'seed': seed, 'dtype': compute_dtype,
                          'backend': backend, 'out': tmp, 'batch': batch},
                         tmp, ranks)
        got = torch.load(os.path.join(tmp, 'params.pt'), weights_only=True)
    if any(r['world'] != ranks or r['trainer_world'] != ranks
           for r in outs):
        fail('dist: ranks saw worlds %s' % [(r['world'], r['trainer_world'])
                                            for r in outs])
    if any(r['digests'] != outs[0]['digests'] for r in outs):
        fail('dist: the ranks\' parameters, EMA or AdamW state differ: %s'
             % [r['digests'] for r in outs])
    if any(r['losses'] != outs[0]['losses'] for r in outs):
        fail('dist: the ranks logged other losses: %s'
             % [r['losses'] for r in outs])
    rel = 1e-3 if compute_dtype else 1e-5
    for i, (a, b) in enumerate(zip(outs[0]['losses'], losses)):
        if not (math.isfinite(a) and abs(a - b) <= rel * abs(b)):
            fail('dist: step %d loss %.8g on %d ranks, %.8g in one process'
                 % (i, a, ranks, b))
    lr = 1e-4
    tol = 2 * lr * DDP_STEPS * 1.01 if compute_dtype else 4.04e-4
    big = total = size = 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        big = max(big, d.max().item())
        total += d.sum().item()
        size += d.numel()
    if not big <= tol:
        fail('dist: parameters after %d steps differ by %.3e > %.3e'
             % (DDP_STEPS, big, tol))
    counts[path] = outs[0]['launches']
    launched(path, counts[path], TRAIN, compute_dtype)
    if compute_dtype is not None:
        TC[path] = outs[0]['tc']
        tensor_cores_only(path, counts[path])
    say('dist', 'ddp%s: %d ranks (%s, %d card(s): %s) x batch %d against one '
        'process at batch %d, SID model, crop %d, dropout 0.1, %d AdamW '
        'steps: losses ranks %s one process %s (tol %.0e rel); parameters '
        'after: max diff %.3e (tol %.3e), mean diff %.3e; parameters, EMA and '
        'AdamW state the same bits on every rank; rank 0 s per step %s (a '
        'correctness check: %s); launches of rank 0 %s'
        % ('' if compute_dtype is None else ' in bf16', ranks, backend,
           torch.cuda.device_count(),
           ' '.join(r['device'] for r in outs), batch, n, TRAIN_CROP,
           DDP_STEPS, json.dumps(outs[0]['losses']), json.dumps(losses), rel,
           big, tol, total / size,
           ' '.join('%.3f' % s for s in outs[0]['secs']),
           'the ranks share one card' if backend == 'gloo'
           else 'one card a rank', json.dumps(counts[path])))


def phase_dist(dev, seed, counts):
    """Batched validation (val_batch) and data-parallel training (ddp)."""
    for dtype in (None, 'bf16'):
        val_batch_agreement(dev, seed, counts, dtype)
    sid_batch(dev, seed, counts)
    for dtype in (None, 'bf16'):
        ddp(dev, seed, counts, dtype)


# ---------------------------------------------------------------- phase 14
FAMILY_BATCH, FAMILY_CROP = 2, 128    # the variants' train steps
FAMILY_SIZE = 256                     # their restoration's input
NG = 32                               # SR3's GroupNorm(32)
UNCOND_SIZE = 128                     # the unconditional images
# per path, the launches of each kernel form (`_build.FORMS`)
FORM_COUNTS = {}
# the kernel forms an AKGM block at norm_groups > 1 runs, and the path of
# the `families` phase whose run gives their launches
FORM_OWNER = {
    'akgm_tail nofold': 'families_ng', 'conv3x3 nofold+swish': 'families_ng',
    'akgm_tail_bwd nofold': 'families_ng_train',
    'conv3x3_bwd nofold+swish': 'families_ng_train',
    'akgm_tail_bf16 nofold': 'families_ng_bf16',
    'conv3x3_bf16 nofold+swish': 'families_ng_bf16',
    'akgm_tail_bwd_bf16 nofold': 'families_ng_train_bf16',
    'conv3x3_bwd_bf16 nofold+swish': 'families_ng_train_bf16'}


def lpips_weights(path, seed):
    """Random weights in the layout of a torch lpips.LPIPS(net='alex') state
    dict, saved to `path`: what PerceptualGaussianDiffusion loads."""
    import torch
    from ucdir_tpu_torch.metrics.lpips import _ALEX_CFG
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for (cout, k, _, _), (sl, idx) in zip(
            _ALEX_CFG, ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))):
        sd['net.slice%d.%d.weight' % (sl, idx)] = torch.randn(
            cout, cin, k, k, generator=g) / (cin * k * k) ** .5
        sd['net.slice%d.%d.bias' % (sl, idx)] = 0.1 * torch.randn(
            cout, generator=g)
        sd['lin%d.model.1.weight' % (sl - 1)] = torch.rand(
            1, cout, 1, 1, generator=g)
        cin = cout
    torch.save(sd, path)
    return path


def family_model(name, tmp, seed, **unet):
    """The SID model options as variant `name` (NoDiffusion's denoiser
    refines the 3-channel initx; PerceptualGaussianDiffusion's LPIPS on
    random weights under `tmp`)."""
    model = sid_model(**unet)
    model['diffusion_name'] = name
    if name == 'NoDiffusion':
        model['unet']['in_channel'] = 3
    if name == 'PerceptualGaussianDiffusion':
        model['lpips_weights'] = lpips_weights(
            os.path.join(tmp, 'lpips_alex.pth'), seed)
    return model


def family_variant(dev, seed, name, tmp):
    """Variant `name` at the SID width: 2 Trainer.optimize_parameters at
    FAMILY_BATCH x FAMILY_CROP with injected draws and dropout off, then the
    card's weights restore one FAMILY_SIZE input with 2 DDPM steps
    (NoDiffusion: its refine pass) through Trainer.test; on the card and on
    the host, held to train_slice's and variants' limits. Returns the card's
    launches."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import Trainer

    rng = np.random.default_rng(seed + 11)
    B, c = FAMILY_BATCH, FAMILY_CROP
    hr = rng.uniform(-0.8, 0.8, (B, c, c, 3)).astype(np.float32)
    lq = (0.2 * hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
    draws = [{'gammas': rng.uniform(0.3, 0.95, (B, 1)).astype(np.float32),
              'noise': rng.standard_normal(hr.shape).astype(np.float32)}
             for _ in range(2)]
    x = rng.uniform(-1, 1, (1, FAMILY_SIZE, FAMILY_SIZE, 3)).astype(
        np.float32)
    side = FAMILY_SIZE + 2 * PAD
    noise = [rng.standard_normal((1, side, side, 3)).astype(np.float32)
             for _ in range(3)]
    opt = train_opt(tmp, model=family_model(name, tmp, seed))
    run, trainers = {}, {}
    for d in (dev, 'cpu'):
        torch.manual_seed(seed)
        tr = trainers[d] = Trainer(opt, device=d, seed=seed)
        tr.model.eval()       # dropout off: both sides run one network
        tr.feed_data({'HR': hr, 'SR': lq})
        if d is dev:
            torch.cuda.synchronize()
            _build.reset_launches()
        t = time.perf_counter()
        losses = []
        for step in draws:
            tr.optimize_parameters(draws={k: torch.from_numpy(v).to(d)
                                          for k, v in step.items()})
            losses.append(tr.get_current_log()['l_pix'])
        if d is dev:
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        run[d] = (losses, time.perf_counter() - t)
    card, host = trainers[dev], trainers['cpu']
    (l_c, s_c), (l_h, s_h) = run[dev], run['cpu']
    for i, (a, b) in enumerate(zip(l_c, l_h)):
        tol = 1e-5 if i == 0 else 1e-4
        if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
            fail('families: %s step %d loss %.8g on the card, %.8g on the '
                 'host' % (name, i, a, b))
    p_err = 0.0
    sd = card.model.state_dict()
    for k, want in host.model.state_dict().items():
        p_err = max(p_err, (sd[k].cpu() - want).abs().max().item())
    if not p_err <= 4.04e-4:
        fail('families: %s parameters differ by %.3e after 2 steps'
             % (name, p_err))
    missing = [k for k in TRAIN if launches[k] == 0]
    if missing:
        fail('families: %s never launched %s' % (name, missing))
    # the restoration, from the card's weights on both sides
    host.model.load_state_dict({k: v.cpu() for k, v in sd.items()})
    out, secs = {}, {}
    for d, tr in trainers.items():
        tr.set_new_noise_schedule(dict(SID_VAL_SCHEDULE, n_timestep=2),
                                  'val', force=True)
        tr.feed_data({'SR': x, 'HR': x})
        t = time.perf_counter()
        tr.test(continous=False, noise=injected(noise, d))
        secs[d] = time.perf_counter() - t
        out[d] = (tr.SR, tr.pre_initx)
    if (out[dev][1] is None) == card.model.has_predictor:
        fail('families: %s test gave initx %s' % (name, out[dev][1]))
    err = agree('families', '%s restoration card vs host' % name,
                torch.from_numpy(out[dev][0]), torch.from_numpy(out['cpu'][0]))
    say('families', '%s, full width: 2 optimize_parameters at batch %d, crop '
        '%d: losses card %s host %s (tol 1e-5, 1e-4 rel), parameters after: '
        'max diff %.3e (tol 4.04e-4), card %.2f s, host %.2f s; %s %dx%d: '
        'card vs host max abs err %.3e (tol 1e-5), card %.2f s, host %.2f '
        's; launches of the steps %s'
        % (name, B, c, json.dumps(l_c), json.dumps(l_h), p_err, s_c, s_h,
           'refine' if card.model.sample_mode == 'refine'
           else '2 DDPM steps', FAMILY_SIZE, FAMILY_SIZE, err, secs[dev],
           secs['cpu'], json.dumps(launches)))
    return launches


def family_frame(dev, seed, name, compute_dtype, path, **unet):
    """Variant `name` with `unet` restores phase_sid's frame with SID_STEPS
    DDPM steps; records the launches (per kernel and per form) under
    `path`."""
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.diffusion.sampler import cast_model
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.models.dy3h import compute_guide_maps
    from ucdir_tpu_torch.models.layers import pad_to_multiple, reflect_pad
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.schedule import make_schedule

    model = build_model(seed, name, **unet).to(dev)
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=SID_STEPS), dev)
    gen = torch.Generator(dev).manual_seed(seed)
    frame = torch.rand((1,) + SID_FRAME + (3,), generator=gen,
                       device=dev) * 2 - 1
    t_pre = 0.0
    if model.has_predictor:
        with torch.no_grad():
            net = (model if compute_dtype is None
                   else cast_model(model, compute_dtype))
            x = reflect_pad(frame, PAD, PAD, PAD, PAD).to(
                compute_dtype or frame.dtype)
            torch.cuda.synchronize()
            t = time.perf_counter()
            compute_guide_maps(net.denoise_fn,
                               pad_to_multiple(net.predict_init(x), 32)[0])
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t
            del x, net
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t = time.perf_counter()
    sr, _ = eval_step(model, sched, frame, pad=PAD, generator=gen,
                      compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    FORM_COUNTS[path] = dict(_build.FORMS)
    TC[path] = _build.tc_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if (sr.shape != frame.shape or sr.dtype != torch.float32
            or not torch.isfinite(sr).all()):
        fail('families: %s frame has shape %s, dtype %s or non-finite values'
             % (path, tuple(sr.shape), sr.dtype))
    launched('families', launches, ('conv3x3', 'gn1_stats'),
             None if compute_dtype is None else 'bf16')
    if compute_dtype is not None:
        tensor_cores_only(path, launches)
    say('families', '%s, %s, frame %dx%d (network %dx%d), %d DDPM steps%s: '
        '%.3f s for the frame; predictor + guide maps %.1f ms, %.1f ms per '
        'DY3h step, peak %.3f GiB, launches %s, per form %s'
        % ((name, json.dumps(unet)) + SID_FRAME + NET_FRAME + (
            SID_STEPS, '' if compute_dtype is None else ' in bf16', secs,
            1e3 * t_pre, 1e3 * (secs - t_pre) / SID_STEPS, peak,
            json.dumps(launches), json.dumps(FORM_COUNTS[path]))))
    del sr, model
    torch.cuda.empty_cache()
    return launches


def family_slice(dev, seed, name, **unet):
    """phase_slice's 96 x 96 restoration (2 steps, injected draws) of
    variant `name` with `unet`, card against host, in float32 (within 1e-5
    max abs, `sid`'s gate) and in bf16. bf16: an AKGM network within 1e-3
    mean abs (bf16_slice's gate); SR3's network (`resname: ResnetBlock`)
    within bf16's own distance from float32 on the host, the mean abs of
    the host's bf16 restoration from its float32 one: this network carries
    a flip of a float32 sum's rounding further than the SID model does
    (its float32 card-against-host reading is several times the SID
    model's too), and its bf16 card against host reads the same with each
    kernel or with each kernel's plain version on the card (PERF.md)."""
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
    host = build_model(seed, name, **unet)
    card = copy.deepcopy(host).to(dev)
    outs = {}
    for dtype in (None, torch.bfloat16):
        for d, model in ((dev, card), ('cpu', host)):
            outs[d, dtype] = [None if o is None else o.cpu() for o in
                              eval_step(model, make_schedule(sched_opt, d),
                                        torch.from_numpy(x).to(d),
                                        noise=injected(draws, d),
                                        compute_dtype=dtype)]
    sr3 = unet.get('resname') == 'ResnetBlock'
    for i, out in enumerate(('sr', 'initx')):
        what = '%s %s: %s' % (name, json.dumps(unet), out)
        got, want = outs[dev, None][i], outs['cpu', None][i]
        if got is None or want is None:
            if (got is None) != (want is None) or card.has_predictor:
                fail('families: %s missing' % what)
            continue
        err = agree('families', '%s card vs host' % what, got, want)
        got, want = outs[dev, torch.bfloat16][i], outs['cpu', torch.bfloat16][i]
        if not torch.isfinite(got).all() or got.shape != want.shape:
            fail('families: %s in bf16 non-finite or misshapen' % what)
        diff = (got - want).abs()
        own = (want - outs['cpu', None][i]).abs().mean().item()
        tol = own if sr3 else 1e-3
        if not diff.mean().item() <= tol:
            fail('families: %s in bf16 card vs host mean abs %.3e > %.3e'
                 % (what, diff.mean().item(), tol))
        say('families', '%s, 96x96, 2 steps: card vs host max abs err %.3e '
            '(tol 1e-5); in bf16 mean abs %.3e (tol %.3e%s), max abs %.3e; '
            'the host\'s bf16 from its float32 mean abs %.3e'
            % (what, err, diff.mean().item(), tol,
               ", bf16's own distance" if sr3 else '', diff.max().item(),
               own))


def family_train(dev, seed, dtype, path, **unet):
    """`train`'s Trainer steps (batch 32, crop 256, dropout on) of the SID
    model with `unet`: 4 steps, the first a warm-up."""
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import Trainer
    hr, lq = train_batch(seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(train_opt(tmp, dtype, model=sid_model(**unet)),
                          device=dev, seed=seed)
        batch, secs, losses, again, peak, per_step, launches = train_steps(
            dev, trainer, hr, lq, 4, path)
        FORM_COUNTS[path] = dict(_build.FORMS)
        launched('families', launches, TRAIN, dtype)
        if dtype is not None:
            tensor_cores_only(path, launches)
        say('families', 'Trainer.optimize_parameters, %s%s, full width, '
            'crop %d (network %dx%d), batch %d, dropout 0.1: %.3f s per step '
            '(mean of 3 after the first), losses %s, the first step\'s draws '
            'again after the last %.6f, peak %.3f GiB, launches in 4 steps '
            '%s, per form %s'
            % (json.dumps(unet), '' if dtype is None else ' in bf16',
               TRAIN_CROP, TRAIN_NET, TRAIN_NET, batch, secs,
               json.dumps([round(v, 6) for v in losses]), again, peak,
               json.dumps(launches), json.dumps(FORM_COUNTS[path])))
        del trainer
    return launches


def family_unconditional(dev, seed):
    """GaussianDiffusion with conditional: false on SR3's blocks at the SID
    width generates one UNCOND_SIZE image with SID_STEPS DDPM steps through
    Trainer.sample, on the card and on the host with injected draws."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.trainer import Trainer

    model = sid_model(in_channel=3, resname='ResnetBlock', norm_groups=NG)
    model['diffusion_name'] = 'GaussianDiffusion'
    model['diffusion'].update(conditional=False, image_size=UNCOND_SIZE)
    opt = {'phase': 'val', 'model': model, 'path': {'resume_state': None},
           'train': {'ema_scheduler': {'use': True}}}
    rng = np.random.default_rng(seed + 12)
    shape = (1, UNCOND_SIZE, UNCOND_SIZE, 3)
    draws = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(SID_STEPS + 1)]
    out, secs = {}, {}
    for d in (dev, 'cpu'):
        torch.manual_seed(seed)
        tr = Trainer(opt, device=d, seed=seed)
        tr.set_new_noise_schedule(dict(SID_VAL_SCHEDULE,
                                       n_timestep=SID_STEPS), 'val',
                                  force=True)
        t = time.perf_counter()
        out[d] = tr.sample(batch_size=1, noise=injected(draws, d))
        secs[d] = time.perf_counter() - t
        if d is dev and tr.get_current_visuals(sample=True)['SAM'].shape \
                != shape:
            fail('families: Trainer.sample gave shape %s'
                 % (out[d].shape,))
    err = agree('families', 'unconditional sample card vs host',
                torch.from_numpy(out[dev]), torch.from_numpy(out['cpu']))
    say('families', 'unconditional GaussianDiffusion, ResnetBlock, '
        'norm_groups %d, full width: Trainer.sample %dx%d, %d DDPM steps: '
        'card vs host max abs err %.3e (tol 1e-5); card %.2f s, host %.2f s'
        % (NG, UNCOND_SIZE, UNCOND_SIZE, SID_STEPS, err, secs[dev],
           secs['cpu']))


def phase_families(dev, seed, counts):
    """Every model define_G builds: the eight variants, then the SR3-style
    network and the AKGM network at norm_groups NG at full size, then
    unconditional generation."""
    import torch
    from ucdir_tpu_torch.diffusion.base import DIFFUSIONS

    with tempfile.TemporaryDirectory() as tmp:
        for name in DIFFUSIONS:
            counts['families_' + name] = family_variant(dev, seed, name, tmp)
            torch.cuda.empty_cache()
    sr3 = dict(resname='ResnetBlock', norm_groups=NG)
    ng = dict(norm_groups=NG)
    for dtype in (None, torch.bfloat16):
        sfx = '' if dtype is None else '_bf16'
        counts['families_sr3' + sfx] = family_frame(
            dev, seed, 'GaussianDiffusion', dtype, 'families_sr3' + sfx,
            **sr3)
        counts['families_ng' + sfx] = family_frame(
            dev, seed, 'ResiGaussianGuideDY', dtype, 'families_ng' + sfx,
            **ng)
        forms = FORM_COUNTS['families_ng' + sfx]
        k1 = 'akgm_tail' + sfx
        if (forms.get(k1 + ' nofold') != BLOCKS * SID_STEPS
                or forms.get(k1 + ' fold')):
            fail('families: the norm_groups %d frame launched %s' % (NG,
                                                                   forms))
    for name, unet in (('GaussianDiffusion', sr3),
                       ('ResiGaussianGuideDY', ng)):
        family_slice(dev, seed, name, **unet)
    for dtype in (None, 'bf16'):
        path = 'families_ng_train' + ('' if dtype is None else '_bf16')
        counts[path] = family_train(dev, seed, dtype, path, **ng)
    family_unconditional(dev, seed)
    missing = [k for k, path in FORM_OWNER.items()
               if not FORM_COUNTS.get(path, {}).get(k)]
    if missing:
        fail('families: kernel forms never launched on their paths: %s'
             % missing)


# ---------------------------------------------------------------- phase 15
EVAL_PAIRS = 4                    # the evaluator's result pairs
EVAL_SIZE = 1024                  # their size: 16 patches of 256 each


def inception_weights(path, seed):
    """Random weights in the layout of a pytorch-fid InceptionV3 state dict
    (convolutions at He's scale, so that the features keep their size
    through the layers; random BatchNorm statistics), saved to `path`:
    what the evaluator loads from UCDIR_TPU_INCEPTION_NPZ."""
    import torch
    from ucdir_tpu_torch.metrics.inception import InceptionV3Features
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in InceptionV3Features().state_dict().items():
        if not k.endswith('.conv.weight'):
            continue
        pref, cout = k[:-len('.conv.weight')], v.shape[0]
        sd[k] = torch.randn(v.shape, generator=g) * (2. / v[0].numel()) ** .5
        sd[pref + '.bn.weight'] = 1 + 0.1 * torch.randn(cout, generator=g)
        sd[pref + '.bn.bias'] = 0.1 * torch.randn(cout, generator=g)
        sd[pref + '.bn.running_mean'] = torch.rand(cout, generator=g) - 0.5
        sd[pref + '.bn.running_var'] = torch.rand(cout, generator=g) + 0.5
    torch.save(sd, path)
    return path


def phase_eval1(dev, seed):
    """The offline evaluator (`python -m ucdir_tpu_torch.eval1 -s <dir>`,
    LPIPS and Inception on the card) over EVAL_PAIRS generated result pairs
    of EVAL_SIZE x EVAL_SIZE with random LPIPS and Inception weights: every
    metric line printed and finite, 16 patches an image, seconds per image;
    then the Inception features of the ground-truth patches, card against
    host, within 1e-4 of the largest."""
    import contextlib
    import io
    import cv2
    import numpy as np
    import torch
    from ucdir_tpu_torch import eval1
    from ucdir_tpu_torch.metrics.fid import inception_features

    rng = np.random.default_rng(seed + 16)
    S = EVAL_SIZE
    yy, xx = np.mgrid[0:S, 0:S] / (S - 1.0)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, 'results')
        os.makedirs(src)
        for i in range(EVAL_PAIRS):
            hr = np.stack([127.5 + 90 * np.sin((5 + i) * xx + c)
                           * np.cos((4 + i) * yy - c) for c in range(3)], -1)
            hr = np.clip(hr + rng.normal(0, 8, hr.shape), 0, 255)
            sr = np.clip(hr + rng.normal(0, 12, hr.shape), 0, 255)
            cv2.imwrite(os.path.join(src, '%d_hr.png' % i),
                        hr.astype(np.uint8))
            cv2.imwrite(os.path.join(src, '%d_sr.png' % i),
                        sr.astype(np.uint8))
        inc = inception_weights(os.path.join(tmp, 'inception.pth'), seed)
        env = {'UCDIR_TPU_LPIPS_WEIGHTS': lpips_weights(
                   os.path.join(tmp, 'lpips.pth'), seed),
               'UCDIR_TPU_INCEPTION_NPZ': inc}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        out = io.StringIO()
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                eval1.main(['-s', src, '--device', str(dev)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        text = out.getvalue()
        lines = {w[0]: float(w[1]) for w in map(str.split, text.splitlines())
                 if len(w) == 2 and w[0] in ('LPIPS', 'PSNR', 'SSIM', 'niqe',
                                             'FID:', 'KID')}
        if 'skipped' in text or len(lines) != 6 or not all(
                math.isfinite(v) for v in lines.values()):
            fail('eval1: metric lines %s from output %r' % (lines,
                                                           text[-2000:]))
        gt_pt = src + '_gt_pt'
        files = sorted(os.listdir(gt_pt))
        if len(files) != EVAL_PAIRS * (S // 256) ** 2:
            fail('eval1: %d ground-truth patches, expected %d'
                 % (len(files), EVAL_PAIRS * (S // 256) ** 2))
        patches = np.stack([cv2.imread(os.path.join(gt_pt, f))
                            for f in files])
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = inception_features(patches, inc, device=dev)
        t_card = time.perf_counter() - t
        host = inception_features(patches, inc, device='cpu')
        err, big = np.abs(card - host).max(), np.abs(host).max()
        if not err <= 1e-4 * big:
            fail('eval1: Inception features card vs host max abs err %.3e > '
                 '1e-4 of the largest %.3e' % (err, big))
        say('eval1', 'python -m ucdir_tpu_torch.eval1 -s <dir> on the card, '
            '%d pairs of %dx%d (%d patches of 256 a side), random LPIPS and '
            'Inception weights: %.3f s, %.3f s per image; %s; Inception '
            'features of the %d patches card vs host max abs err %.3e (tol '
            '1e-4 of the largest, %.3e), card %.3f s'
            % (EVAL_PAIRS, S, S, len(files), secs, secs / EVAL_PAIRS,
               json.dumps(lines), len(files), err, big, t_card))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--ddp_worker', type=str, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument('--resident_worker', type=str, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ddp_worker:
        sys.path.insert(0, ROOT)
        return ddp_worker(args.ddp_worker)
    if args.resident_worker:
        sys.path.insert(0, ROOT)
        return resident_worker(args.resident_worker)

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
    t0 = time.perf_counter()

    def done(phase):
        say('time', '%s done at %.1f s' % (phase, time.perf_counter() - t0))

    phase_build()
    done('build')
    phase_kernels(dev, args.seed, results)
    done('kernels')
    phase_slice(dev, args.seed)
    counts = {'main': phase_main(dev, args.seed)}
    sr32, counts['sid'] = phase_sid(dev, args.seed)
    phase_bf16(dev, args.seed, counts, sr32)
    del sr32
    done('slice, main, sid, bf16')
    counts['train_slice'] = phase_train_slice(dev, args.seed)
    counts['train_slice_24'] = phase_train_slice(dev, args.seed,
                                                 inner_channel=24)
    counts['train_slice_bf16'] = phase_train_slice(dev, args.seed, 'bf16')
    counts['train'] = phase_train(dev, args.seed)
    counts['train_bf16'] = phase_train_bf16(dev, args.seed)
    phase_tails_train_bf16(dev, args.seed, counts)
    done('train_slice, train, train_bf16')
    phase_variants(dev, args.seed, counts)
    done('variants')
    phase_fewstep(dev, args.seed, counts)
    phase_hires(dev, args.seed, counts)
    done('fewstep, hires')
    phase_resident(dev, args.seed, counts)
    done('resident')
    phase_tasks(dev, args.seed, counts)
    phase_realsr(dev, args.seed, counts)
    done('tasks, realsr')
    phase_dist(dev, args.seed, counts)
    done('dist')
    phase_families(dev, args.seed, counts)
    done('families')
    phase_eval1(dev, args.seed)
    done('eval1')
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
    # the forms of K1, K2, K5 and K6 that a block at norm_groups > 1 runs:
    # phase 2's cases of each form, launches from the `families` path
    for name, path in FORM_OWNER.items():
        kernel = name.split()[0]
        r = results[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': KERNELS[kernel][0],
            'replaces': KERNELS[kernel][1],
            'launches': FORM_COUNTS[path][name],
            'tc_launches': TC.get(path, {}).get(kernel),
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
