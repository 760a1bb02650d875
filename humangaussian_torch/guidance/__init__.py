"""The dual-branch SD2 prior: schedule, VAE, UNet, prompts, guidance."""
