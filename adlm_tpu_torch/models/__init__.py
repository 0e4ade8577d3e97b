"""Models of the PyTorch port: DeepLabV2 backbone and the PPNet head."""
