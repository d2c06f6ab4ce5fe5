"""ucdir_tpu_torch — the PyTorch and CUDA port of ucdir_tpu for one NVIDIA
H100 (sm_90a). This version carries validation and training end to end
(`python -m ucdir_tpu_torch.sr -p val|train -c <yaml>`) for SID, GoPro
deblurring, JPEG restoration and Real-SR: UNetSeeInDark, the guide maps,
ancestral DDPM (or few-step) steps of DY3h, + initx, with the hand-written
CUDA kernels of `csrc/` on the card; and every other model `define_G`
builds (the eight diffusion variants, SR3's `ResnetBlock`, GroupNorm(G)). Activations are NHWC; parameters keep
the reference's state-dict names and OIHW layout. It imports no JAX."""
