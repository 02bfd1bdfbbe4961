"""The command line of the PyTorch port: ``python -m outfitx_tpu_torch.cli``."""
