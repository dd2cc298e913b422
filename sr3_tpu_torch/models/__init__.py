"""Schedule, UNet, diffusion chain, network factory."""
