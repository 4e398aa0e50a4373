"""Model builders of the PyTorch port."""
