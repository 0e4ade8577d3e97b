"""Configuration, device and dtype policy of the PyTorch port."""
