"""Evaluation and interpretability statistics of the PyTorch port."""
